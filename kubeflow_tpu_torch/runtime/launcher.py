"""In-pod launcher for the port's built-in trainer (port of the `--config`
path of kubeflow_tpu/runtime/launcher.py).

Loads a TrainConfig from JSON or YAML, runs Trainer.fit on one device,
prints `{"summary": ...}` as its last line and exits 0. The device is
cuda unless `--device cpu` is given; with no GPU and no `--device cpu`
it fails rather than train on the CPU. No elastic, preemption or tracing
hooks yet (ROADMAP Queue 1 item 15).

Usage:
    python -m kubeflow_tpu_torch.runtime.launcher --config cfg.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def load_config(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        from kubeflow_tpu_torch.utils import yaml_lite

        return yaml_lite.loads(text)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True,
                   help="TrainConfig JSON/YAML for the built-in trainer")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    cfg = TrainConfig.from_dict(load_config(args.config))
    summary = Trainer(cfg, device=args.device).fit()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
