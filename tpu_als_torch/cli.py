"""Command line: ``python -m tpu_als_torch.cli recommend ...``.

Counterpart of ``tpu_als/cli.py::cmd_recommend``: load a saved model
(either package's save), optionally fold new ratings in — items first
(``--foldin-items-data``), then users (``--foldin-data``) — and print one
JSON line per user, ``{"user": id, "items": [[item, score], ...]}`` with
scores rounded to 4 decimals.  Fold-in data is ``csv:PATH``, strict
``int,int,float,int`` with a header.  ``--device`` defaults to the CUDA
device; pass ``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_foldin(spec):
    from tpu_als_torch.io.ratings_csv import load_ratings_csv

    kind, _, arg = spec.partition(":")
    if kind != "csv":
        raise SystemExit(f"unknown fold-in data spec {spec!r} (use "
                         "csv:PATH)")
    return load_ratings_csv(arg)


def cmd_recommend(args):
    from tpu_als_torch.api.estimator import ALSModel
    from tpu_als_torch.stream.microbatch import FoldInServer
    from tpu_als_torch.utils.frame import ColumnarFrame

    model = ALSModel.load(args.model, device=args.device)
    if args.foldin_data or args.foldin_items_data:
        srv = FoldInServer(model)
        if args.foldin_items_data:
            batch = _load_foldin(args.foldin_items_data)
            touched = srv.update_items(batch)
            print(f"folded in {len(batch)} ratings touching "
                  f"{len(touched)} items", file=sys.stderr)
        if args.foldin_data:
            batch = _load_foldin(args.foldin_data)
            touched = srv.update(batch)
            print(f"folded in {len(batch)} ratings touching "
                  f"{len(touched)} users", file=sys.stderr)
    if args.users:
        try:
            ids = np.array([int(x) for x in args.users.split(",")])
        except ValueError:
            raise SystemExit(f"--users takes comma-separated integer ids, "
                             f"got {args.users!r}") from None
        recs = model.recommendForUserSubset(
            ColumnarFrame({model._params["userCol"]: ids}), args.k)
    else:
        recs = model.recommendForAllUsers(args.k)
    key = recs.columns[0]
    limit = args.limit if args.limit > 0 else len(recs)
    for row in range(min(limit, len(recs))):
        print(json.dumps({
            "user": int(recs[key][row]),
            "items": [[int(i), round(float(s), 4)]
                      for i, s in recs["recommendations"][row]]}))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tpu_als_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("recommend", help="top-k recommendations")
    r.add_argument("--model", required=True)
    r.add_argument("--users", default=None,
                   help="comma-separated original user ids (default: all)")
    r.add_argument("--k", type=int, default=10)
    r.add_argument("--limit", type=int, default=20,
                   help="max users to print (0 = all)")
    r.add_argument("--foldin-data", default=None,
                   help="ratings (csv:PATH) to fold into the user factors "
                        "before recommending")
    r.add_argument("--foldin-items-data", default=None,
                   help="ratings (csv:PATH) whose items are folded in "
                        "against the fixed user factors; applied before "
                        "--foldin-data")
    r.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    r.set_defaults(fn=cmd_recommend)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
