"""Config/flag system: frozen dataclasses + argparse bridge.

Counterpart of ``bayesic_tpu/utils/config.py`` (the same code: it uses
only the standard library).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

__all__ = ["parse_config", "dump_config", "asdict"]


def asdict(cfg):
    return dataclasses.asdict(cfg)


def parse_config(cls, argv=None, description=None):
    """Build an argparse parser from dataclass ``cls`` fields; returns an
    instance with CLI overrides applied."""
    parser = argparse.ArgumentParser(description=description
                                     or cls.__doc__)
    for f in dataclasses.fields(cls):
        arg = "--" + f.name.replace("_", "-")
        default = (
            f.default if f.default is not dataclasses.MISSING
            else f.default_factory()
        )
        if f.type in (bool, "bool") or isinstance(default, bool):
            parser.add_argument(arg, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=default)
        else:
            parser.add_argument(arg, type=type(default), default=default)
    ns = parser.parse_args(argv if argv is not None else sys.argv[1:])
    return cls(**vars(ns))


def dump_config(cfg, path=None):
    s = json.dumps(asdict(cfg), indent=2, default=str)
    if path:
        with open(path, "w") as f:
            f.write(s + "\n")
    return s
