"""CLI: the AU intensity error of two OpenFace CSVs (counterpart of
instag_tpu/cli/auerror.py).

    python -m instag_torch.cli.auerror --pred pred_au.csv --gt gt_au.csv
"""

from __future__ import annotations

import argparse
import json

from ..metrics import au_error


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("auerror")
    parser.add_argument("--pred", required=True)
    parser.add_argument("--gt", required=True)
    args = parser.parse_args(argv)
    out = au_error(args.pred, args.gt)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
