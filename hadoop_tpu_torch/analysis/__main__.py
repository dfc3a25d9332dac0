"""``python -m hadoop_tpu_torch.analysis``: the port's conf registry gate.

    python -m hadoop_tpu_torch.analysis --write-conf-registry [ROOT]
    python -m hadoop_tpu_torch.analysis --check-conf-registry [ROOT]

``ROOT`` is the repository that holds ``hadoop_tpu_torch/`` and
``README.md`` (default: the one this package sits in), or a path inside
that package. ``--write-conf-registry`` regenerates
``hadoop_tpu_torch/conf/registry.py`` and the README's port appendix
and exits 0. ``--check-conf-registry`` exits 1 with a diff when
regenerating would change either, 0 when both are current. A usage
error exits 2. Every new conf read in the port needs a
``--write-conf-registry`` run, or the check (a tier-1 test) fails.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def _default_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _repo_root(path: str) -> str:
    root = os.path.abspath(path)
    if os.path.isfile(root):
        root = os.path.dirname(root)
    while os.path.isfile(os.path.join(root, "__init__.py")):
        root = os.path.dirname(root)
    return root


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hadoop_tpu_torch.analysis",
        description="the port's conf-key registry: regenerate or check")
    ap.add_argument("root", nargs="?", default=None,
                    help="the repository (or a path in its package)")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--write-conf-registry", action="store_true",
                      help="regenerate the registry and the README "
                           "appendix, then exit 0")
    mode.add_argument("--check-conf-registry", action="store_true",
                      help="exit 1 with a diff when regenerating would "
                           "change anything")
    args = ap.parse_args(argv)
    if args.root is not None and not os.path.exists(args.root):
        print(f"analysis: no such path: {args.root}", file=sys.stderr)
        return 2
    root = _repo_root(args.root) if args.root else _default_root()

    from hadoop_tpu_torch.analysis import confscan
    if args.write_conf_registry:
        changed = confscan.write_registry(root)
        print("analysis: conf registry "
              + (f"updated ({', '.join(changed)})" if changed
                 else "already current"))
        return 0
    ok, diff = confscan.check_registry(root)
    if ok:
        print("analysis: conf registry current")
        return 0
    for line in diff[:120]:
        print(line)
    print(f"analysis: conf registry is STALE — run "
          f"`{confscan.COMMAND} --write-conf-registry` and commit")
    return 1


if __name__ == "__main__":
    sys.exit(main())
