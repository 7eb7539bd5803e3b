"""A throwaway benchmark root whose cells run the TINY sizes on the CPU.

Copies `bench/` and `BENCHMARK.json` into a directory and rewrites the copies'
configuration and traffic files by file only (the widths of the port's
``configs.vgg9_snn.TINY``, a few slots, a short pool), so that the harness
drives whole runs there without a card.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {"num_classes": 4, "population": 64, "img_hw": 16,
        "stages": [8, 12, "MP", 16, 16, "MP"], "fc_dim": 32}
#: the published widths on 8 x 8 images: small enough for the CPU, wide
#: enough that each sum has as many terms as at full size
NARROW_IMAGES = {"img_hw": 8}


def make_root(dst: Path, slots: int = 4, pool: int = 16, rate: float = 100.0,
              sizes: dict = TINY, sample: int = 4096) -> Path:
    dst = Path(dst)
    shutil.copytree(REPO / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        (dst / c["file"]).write_text(json.dumps({**cfg, **sizes}))
    for path in (REPO / "bench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if "engine" in t:
            t["engine"].update(slots=slots, max_queue=max(2 * slots, t["engine"]["max_queue"]))
            t.update(pool=pool, check_sample=sample, traced_steps=2, warmup_steps=1)
        if "clients" in t:
            t["clients"] = slots
        if "arrivals" in t:
            t["arrivals"]["rate_per_s"] = rate
        if t["kind"] == "train":
            t.update(batch=4, pool_batches=4, traced_steps=2)
        (dst / "bench" / "traffic" / path.name).write_text(json.dumps(t))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst
