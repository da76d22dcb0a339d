"""ModelTransfer CLI: convert between model formats (ref:
src/ModelTransfer.cpp converts .mat -> .xml; this version converts any
supported format to any other by extension, including the canonical
.npz).

    python -m partsbaseddetector_tpu_torch.apps.model_transfer SRC DST

A copy of `partsbaseddetector_tpu/apps/model_transfer.py` on the port's
readers and writers.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pbd-model-transfer", description=__doc__)
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)

    from ..models import FileStorageModel, MatlabIOModel, load_model, save_model

    model = load_model(args.src)
    dst = args.dst.lower()
    if dst.endswith(".npz"):
        save_model(model, args.dst)
    elif dst.endswith((".xml", ".yml", ".yaml")):
        if not dst.endswith(".xml"):
            raise SystemExit("FileStorage writer emits XML; use a .xml path")
        FileStorageModel.write(model, args.dst)
    elif dst.endswith(".mat"):
        MatlabIOModel.write(model, args.dst)
    else:
        raise SystemExit(f"unsupported destination format: {args.dst}")
    print(
        f"converted {args.src} -> {args.dst} "
        f"({model.ncomponents} component(s), {model.nparts(0)} parts)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
