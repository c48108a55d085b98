"""Seconds from the start of the command to the window's first step:
imports, kernel libraries (built on a checkout's first run), the markers,
the warm-up run and, on several cards, the processes and NCCL."""


def read(r):
    return r.results[0]["setup_s"]
