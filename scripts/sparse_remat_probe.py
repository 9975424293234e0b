"""Does the KITTI-scale sparse (band-engine) self-sup train step fit in
device memory without remat, and what does it cost?  Runs a few
synthetic steps at each setting and prints the steady step time.

Usage: python -u scripts/sparse_remat_probe.py
"""
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import rslo_tpu.utils.jax_cache  # noqa: F401

from rslo_tpu.config.schema import PipelineCfg


def main():
    from rslo_tpu.cli import main as cli
    for remat in (True, False):
        cfg = PipelineCfg()
        cfg = cfg.replace(middle=dataclasses.replace(
            cfg.middle, name="SparseMiddleCov", engine="band",
            remat=remat))
        with tempfile.TemporaryDirectory() as td:
            p = Path(td) / "cfg.json"
            p.write_text(cfg.to_json())
            print(f"=== remat={remat} ===", flush=True)
            try:
                cli(["train", "--config", str(p), "--model_dir",
                     str(Path(td) / "m"), "--synthetic", "--steps", "8"])
            except Exception as e:  # OOM etc — report, keep going
                print(f"remat={remat} FAILED: {type(e).__name__}: {e}",
                      flush=True)


if __name__ == "__main__":
    main()
