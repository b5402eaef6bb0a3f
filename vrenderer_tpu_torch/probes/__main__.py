"""Run the probes: ``python -m vrenderer_tpu_torch.probes [peak|eval|merge|
window] [--device cpu] [--small]``. On the CUDA device unless ``--device``
names another; without a card it raises. Prints one JSON line a probe
(each case's check, times, rates and bound) with the card's name."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from vrenderer_tpu_torch.probes import eval as eval_
from vrenderer_tpu_torch.probes import merge, peak, window

PROBES = {"peak": peak, "eval": eval_, "merge": merge, "window": window}


def card_name() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vrenderer_tpu_torch.probes")
    ap.add_argument("probes", nargs="*", choices=[*PROBES, []],
                    help="which probes (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="the tests' sizes")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("the probes run on the CUDA device and none is "
                             "available; pass --device cpu for the plain "
                             "versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = card_name() if device.type == "cuda" else "cpu (plain versions)"
    with torch.no_grad():
        for name in args.probes or list(PROBES):
            res = PROBES[name].run(device, small=args.small)
            print(json.dumps({"probe": name, "device": card, **res}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
