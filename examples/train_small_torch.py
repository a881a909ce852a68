"""Train a ~100M-param qwen3-family model on the GPU, with checkpoint /
restart fault tolerance demonstrated mid-run: the run stops halfway (a
simulated crash), and a second run restores the latest checkpoint and the
data stream's position and trains on to the end.

Run:  PYTHONPATH=src python examples/train_small_torch.py [--steps 200]
      PYTHONPATH=src python examples/train_small_torch.py --device cpu --smoke --steps 4
"""
import argparse
import math
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.train import run_training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (fails without one); 'cpu' to run on the CPU")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced qwen3 config at batch 2 x 16 tokens")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg, batch, seq_len = get_smoke_config("qwen3-32b"), 2, 16
    else:   # ~100M params: qwen3 family, 8 layers x 512 wide
        cfg = get_config("qwen3-32b").scaled(
            num_layers=8, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
            d_ff=1536, vocab_size=32000)
        batch, seq_len = 8, 256
    print(f"model: qwen3-family {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.num_layers}L x {cfg.d_model})")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_small_")
    half = args.steps // 2
    every = max(half // 2, 1)
    kw = dict(device=args.device, global_batch=batch, seq_len=seq_len,
              ckpt_dir=ckpt_dir, ckpt_every=every, log_every=10)

    print(f"\n-- phase 1: steps 0..{half} (then simulated crash) --")
    first = run_training(cfg, steps=half, **kw)

    print(f"\n-- phase 2: restart from checkpoint, steps ..{args.steps} --")
    second = run_training(cfg, steps=args.steps, **kw)
    print(f"\nfinal loss {second[-1]:.4f} (uniform entropy would be "
          f"{math.log(cfg.vocab_size):.2f})")
    return first, second


if __name__ == "__main__":
    main()
