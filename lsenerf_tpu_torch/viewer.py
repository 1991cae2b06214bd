"""Serve the interactive web viewer for a trained model. Port of the
repo's viewer.py: loads a checkpoint as `lsenerf_tpu_torch.render` does,
then serves the orbit page (engine/viewer.py).

    python -m lsenerf_tpu_torch.viewer --load-dir <run>/checkpoints --load-config <run>/config.yml \\
        [--data <scene_dir>] [--host 127.0.0.1] [--port 7007] [--resolutions 96,384] [--device cpu]

It renders on the CUDA card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lsenerf_tpu_torch.viewer")
    ap.add_argument("--load-dir", required=True)
    ap.add_argument("--load-config", required=True)
    ap.add_argument("--data", default="")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7007)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--resolutions", default="96,384",
                    help="comma-separated max-dim ladder: first = drag preview, last = idle full render")
    ap.add_argument("--device", default=None, help="cpu for the plain PyTorch path (default: the card)")
    ns = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from lsenerf_tpu_torch.engine import viewer as viewer_lib
    from lsenerf_tpu_torch.render import load_trained

    trainer, col, _, step = load_trained(ns.load_dir, ns.load_config, ns.data, ns.device)
    print(f"[viewer] restored step {step}")
    session = viewer_lib.ViewerSession(
        trainer.params["model"], col.cameras.to(trainer.device), trainer.occ, trainer.model_config,
        appearance_id=int(col.appearance_ids[0]),
        resolutions=[int(r) for r in ns.resolutions.split(",")], chunk=ns.chunk)
    viewer_lib.serve(session, host=ns.host, port=ns.port)


if __name__ == "__main__":
    main()
