"""Minimal fire-style CLI dispatcher (a copy of ``wesup_tpu.cli``, which the
port cannot import without jax).

The reference exposes its entry points through ``fire.Fire`` (train.py:31-32,
infer.py:152-153); ``fire`` is not available in this environment, so this
module reproduces the calling convention we need:

    python -m wesup_tpu_torch.train <positional> key=value --key value --flag

Values are parsed with ``ast.literal_eval`` falling back to strings, so
``epochs=5``, ``scales=0.5,0.4`` and ``smoke=True`` behave like fire.
"""

from __future__ import annotations

import ast
import sys


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        if "," in text:
            parts = [_parse_value(p) for p in text.split(",") if p != ""]
            return tuple(parts)
        return text


def parse_argv(argv=None):
    """Returns (positional_args, kwargs)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args, kwargs = [], {}
    i = 0
    while i < len(argv):
        token = argv[i]
        if token.startswith("--"):
            key = token[2:].replace("-", "_")
            if "=" in key:
                key, val = key.split("=", 1)
                kwargs[key] = _parse_value(val)
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                kwargs[key] = _parse_value(argv[i + 1])
                i += 1
            else:
                kwargs[key] = True
        elif "=" in token:
            key, val = token.split("=", 1)
            kwargs[key.replace("-", "_")] = _parse_value(val)
        else:
            args.append(_parse_value(token))
        i += 1
    return args, kwargs


def run(func, argv=None):
    """fire.Fire(func) equivalent."""
    args, kwargs = parse_argv(argv)
    return func(*args, **kwargs)
