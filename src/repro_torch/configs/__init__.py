"""Configs of the torch port (``w2v.py`` is a verbatim copy)."""
