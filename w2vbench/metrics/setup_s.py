"""Seconds from the process's start to the first measured step or query:
imports, corpus, tables, index, the kernel library's load or build, and
the warm-up and check steps (host clock)."""


def read(rec):
    return rec["setup_s"]
