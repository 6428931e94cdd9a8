#!/usr/bin/env python
"""Hazard linter of the PyTorch/CUDA port (the counterpart of
``tools/lint.py``).

Runs the :mod:`mxnet_tpu_torch.analysis.astlint` rules — host syncs in step
programs, branches on their tensor arguments, nondeterminism in op code,
mutable default arguments, unlocked global-registry mutation, host arrays
closed over by a step program, a sync per dispatch in a host loop — over
the port's source. Runs on the CPU; imports neither JAX nor torch.

Usage::

    python tools/torch_lint.py                  # lint mxnet_tpu_torch/
    python tools/torch_lint.py path [path ...]  # specific files/trees
    python tools/torch_lint.py --list-rules     # rule catalog

Exit status: 0 clean, 1 violations. A finding that is meant stays with an
inline suppression that gives its reason (``# lint: disable=JH001  --
why``).
"""
import argparse
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_PATHS = ["mxnet_tpu_torch"]


def _astlint():
    """The linter module alone (its package imports torch; the linter needs
    only the standard library)."""
    path = os.path.join(REPO, "mxnet_tpu_torch", "analysis", "astlint.py")
    spec = importlib.util.spec_from_file_location("_torch_astlint", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="files or trees "
                    f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="summary line only")
    args = ap.parse_args(argv)
    astlint = _astlint()
    if args.list_rules:
        for rule in astlint.list_rules():
            print(f"{rule.rule_id}  {rule.summary}")
        return 0
    paths = args.paths or [os.path.join(REPO, p) for p in DEFAULT_PATHS]
    violations = astlint.lint_paths(paths)
    if not args.quiet:
        for v in violations:
            path = os.path.relpath(v.path, REPO) if os.path.isabs(v.path) \
                else v.path
            print(f"{path}:{v.line}:{v.col}: {v.rule} {v.message}")
    scope = ", ".join(os.path.relpath(p, REPO) if os.path.isabs(p) else p
                      for p in paths)
    if violations:
        print(f"lint: {len(violations)} violation(s) in {scope}")
        return 1
    print(f"lint: clean ({scope})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
