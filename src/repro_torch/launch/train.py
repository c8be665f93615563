"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --tiny --steps 50 --batch 8 --seq 128 --device cpu

Full-parameter training of one architecture on the synthetic stream with
its config's optimizer, printing the reference's line every
``--log-every`` steps (and at the last).  It trains on the CUDA device and
raises when there is none; ``--device cpu`` trains on the CPU with the
kernels' plain versions.  On the card a last line gives the peak device
memory.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as cfg_lib
from repro_torch.core.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.training import checkpoint, data, train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(cfg_lib.ARCH_IDS))
    ap.add_argument("--tiny", action="store_true",
                    help="use the reduced smoke-test variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where to train (default: the CUDA device, an "
                         "error without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = cfg_lib.get_tiny_config(args.arch) if args.tiny \
        else cfg_lib.get_config(args.arch)
    api = get_model(cfg)
    params = api.init_params(0, device=dev)
    init_opt, step = train_loop.make_train_step(cfg, lr=args.lr, device=dev)
    opt = init_opt(params)
    stream = data.make_stream(cfg.vocab_size, args.seq, args.batch)

    extra = None
    if cfg.frontend == "vision_stub":
        extra = torch.zeros((args.batch, min(cfg.num_patches, 8),
                             cfg.d_model), dtype=cfg.activation_dtype,
                            device=dev)
    if cfg.frontend == "audio_stub":
        extra = torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model),
                            dtype=cfg.activation_dtype, device=dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    for i, batch in zip(range(args.steps), stream):
        if extra is not None:
            batch = dict(batch, extra_embeds=extra)
        params, opt, m = step(params, opt, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            print(f"step {i:5d} loss={loss:.4f} gnorm={gnorm:.3f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if dev.type == "cuda":
        print(f"peak_memory_gib="
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f}",
              flush=True)
    if args.ckpt_dir:
        path = checkpoint.save(params, args.ckpt_dir, f"{cfg.name}-final")
        print(f"saved {path}")


if __name__ == "__main__":
    main()
