#!/usr/bin/env python3
"""Time the port's fused InstanceNorm + LeakyReLU kernel (K2,
``light_unet_tpu_torch/csrc/instance_norm.cu``) with its chunks sized for
1, 2, 3 or 4 CTAs per SM (``kCtasPerSmTarget``; the kernel ships with 2).

    python3 scripts/bench_torch_norm_chunks.py [--targets 1 2 3 4]

Needs one NVIDIA GPU and nvcc.  Each target builds its own copy of the
package (under a temporary directory) with only the constant changed, then
runs the four serving shapes in bf16 at B = 192 in a process of its own:
checked against the plain version (2e-2 abs), device ms per call from
torch.profiler (10 calls) and CUDA-event ms per call (20 calls), and their
sums over the 23 calls of one forward.
"""

import argparse
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONSTANT = "constexpr int kCtasPerSmTarget = 2;"

TIMING = r"""
import sys
variant, root, target = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path[:0] = [variant, root]
import torch
import chip_smoke as cs
from light_unet_tpu_torch.ops import norm_kernel as nk
assert nk.__file__.startswith(variant), nk.__file__
gen = torch.Generator(device="cuda").manual_seed(0)
calls = {(48, 16): 6, (24, 32): 6, (12, 64): 6, (6, 128): 5}
tot_dev = tot_ev = 0.0
for (d, c), n in calls.items():
    x = (torch.randn((192, d, d, d, c), generator=gen, device="cuda") * 3 + 1).to(torch.bfloat16)
    s = 0.5 + 0.05 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    run = lambda: nk.fused_instance_norm_leaky_relu(x, s, b)
    err = (run().float() - nk.reference_instance_norm_leaky_relu(x, s, b).float()).abs().max()
    assert err.item() <= 2e-2, err.item()
    ev = cs.cuda_ms(run, iters=20)
    _, dev, _ = cs.device_launches(run, "in_leaky", calls=10)
    p = nk.kernel_plan(tuple(x.shape), torch.bfloat16)
    tot_dev += n * dev
    tot_ev += n * ev
    print(f"target {target} {d}^3x{c}: k {p['k']}, {p['ctas_per_sm']} CTAs/SM, "
          f"{p['groups']} samples/round: device {dev:.4f} ms, events {ev:.4f} ms", flush=True)
print(f"target {target} forward: device {tot_dev:.4f} ms, events {tot_ev:.4f} ms", flush=True)
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--targets", type=int, nargs="+", default=[1, 2, 3, 4])
    args = parser.parse_args()
    print(cs_smi(), flush=True)
    with tempfile.TemporaryDirectory(prefix="norm_chunks_") as tmp:
        for target in args.targets:
            dst = Path(tmp) / f"target{target}"
            shutil.copytree(ROOT / "light_unet_tpu_torch", dst / "light_unet_tpu_torch",
                            ignore=shutil.ignore_patterns("_kernels_build", "residual_block.cu"))
            src = dst / "light_unet_tpu_torch/csrc/instance_norm.cu"
            text = src.read_text()
            if CONSTANT not in text:
                raise SystemExit(f"{CONSTANT!r} not found in {src}")
            src.write_text(text.replace(CONSTANT, CONSTANT.replace("= 2", f"= {target}")))
            subprocess.run([sys.executable, "-c", TIMING, str(dst), str(ROOT), str(target)],
                           check=True)
    return 0


def cs_smi() -> str:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke.nvidia_smi()


if __name__ == "__main__":
    sys.exit(main())
