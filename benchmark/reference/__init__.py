"""Plain references, one module per kind of configuration, named by the
configuration file's "reference" key.  Each is plain PyTorch, imports nothing
of the program, and takes nothing the program made but the state it is asked
to follow or judge."""

import importlib


def module(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")
