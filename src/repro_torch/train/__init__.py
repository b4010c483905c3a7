"""Training resilience of the torch port: checkpoints with exact resume
(``checkpoint``), recovery primitives (``resilience``), the supervised
loop (``supervisor``) and deterministic fault schedules (``chaos``)."""
