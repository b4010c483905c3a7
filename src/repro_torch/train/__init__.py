"""Training of the torch port: checkpoints with exact resume
(``checkpoint``), recovery primitives (``resilience``), the supervised
loop (``supervisor``), deterministic fault schedules (``chaos``), and the
LM substrate's AdamW (``optim``) and training loop (``loop``). Each is
imported by name, so that this package's import stays torch-free."""
