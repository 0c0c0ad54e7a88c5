"""Plain references of the benchmark's configurations, one module a
family, named by the configuration file's ``reference`` key.  They import
neither JAX nor the JAX package nor anything of the port."""
from __future__ import annotations

import importlib


def load(name: str):
    """The ``Reference`` class of ``portbench/reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{name}").Reference
