"""Training CLI (port of `tools/train.py`).

    python -m yololite_tpu_torch.tools.train --model configs/models/edge_n.yaml \
        --train configs/train/standard_train.yaml --data dataset.yaml \
        [--epochs N --batch_size B --img_size S --save_by AP --device cuda ...]

Runs on `--device` (the card by default). `--data_parallel N` trains on N
GPUs, one process each (unset: every visible GPU); `--spatial_parallel S`
splits each image's height over S of them, a mesh of N x S processes
(unset N: the visible GPUs divided by S). Under
`torchrun --nproc_per_node N [--nnodes M ...] -m yololite_tpu_torch.tools.train`
it joins torchrun's processes instead (N x S of them with `--spatial_parallel`).
"""

from __future__ import annotations

from yololite_tpu_torch.config import apply_overrides, build_argparser, load_configs
from yololite_tpu_torch.train.loop import train_from_config


def main(argv=None):
    opt = build_argparser().parse_args(argv)
    config = load_configs(model_yaml=opt.model, train_yaml=opt.train, data_yaml=opt.data)
    config = apply_overrides(config, opt)
    results = train_from_config(config, device=config["training"].get("device") or "cuda")
    print(f"Done. best {config['training'].get('save_by') or 'AP'}="
          f"{results.get('best_metric', -1):.4f} -> {results.get('log_dir')}")
    return results


if __name__ == "__main__":
    main()
