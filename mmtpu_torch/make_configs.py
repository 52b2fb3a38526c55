"""Grid materializer CLI (port of :mod:`mmtpu.make_configs`, the reference's
``configs/make_configs.py``): writes ``config_<i>.json`` files and an index
CSV through :func:`mmtpu_torch.config.write_grid`.

Usage: python -m mmtpu_torch.make_configs [folder] [--seed 0] [--no-shuffle]

Unlike the reference's unseeded ``random.shuffle`` (make_configs.py:53), the
shuffle is seeded (``--seed``); ``--no-shuffle`` keeps the enumeration order.
"""

from __future__ import annotations

import argparse

from mmtpu_torch.config import write_grid


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mmtpu_torch.make_configs", description=__doc__)
    parser.add_argument("folder", nargs="?", default="configs/multimodal_search")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-shuffle", action="store_true")
    args = parser.parse_args(argv)
    n = write_grid(args.folder, None if args.no_shuffle else args.seed)
    print(f"wrote {n} configs to {args.folder}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
