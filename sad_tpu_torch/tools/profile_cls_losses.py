"""What bounds the cls-loss kernels on the card: bytes, issue slots or latency.

    python -m sad_tpu_torch.tools.profile_cls_losses [--batch 8] [--groups 4] \
        [--iters 50] [--seed 0] [--out profile_cls_losses.json]

At the joint step's P3 shape (--batch x 80 x 128 x 9 rows of 80 classes,
--groups groups; the flagship arithmetic: gammas 2, beta 0, PowSum 1.8) it
times the device time of a call (torch.profiler over --iters calls after 5
warm-up calls; the forward's includes its sum kernel):
- each kernel instance of csrc/cls_losses.cu: the forward with 16-byte
  chunks (the main path), the same with PowSum off, the generic instance
  (runtime gammas and beta, powf) and the scalar instance; the backward's
  gamma-2, generic and scalar instances. Instances that do more arithmetic
  on the same bytes take longer only where the issue slots bound the kernel;
- two PyTorch passes that move the kernels' bytes with almost no
  arithmetic, the rates the card reaches on such a stream: x.sum() and
  pt.sum() (8 bytes an element read, the forward's bytes) and
  torch.add(x, pt, out=dx) (8 read, 4 written: the backward's);
- the SM clock and power draw while the forward runs (nvidia-smi);
- the registers, stack and spills of each instance (the ptxas lines of the
  build), and its static SASS instructions, all and MUFU (cuobjdump -sass
  of the built library, where the toolkit has cuobjdump).
The public wrappers pick the instance from the shapes and pointers, so the
tool forces each one through the wrapper's launchers, which count their
launches as the wrappers' do. Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import torch

from sad_tpu_torch.device import nvidia_smi_line
from sad_tpu_torch.ops import _build
from sad_tpu_torch.ops import cls_loss_kernel as K
from sad_tpu_torch.tools.profile_infer import device_ms

FLAGSHIP = K.ClsLossParams(2.0, 0.25, 2.0, 0.5, 0.0, -1, 1.8, True)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
P3_HW, ANCHORS, C = (80, 128), 9, 80


def _ms(fn, iters: int) -> float:
    return sum(device_ms(fn, iters, 5).values())


def _inputs(rows: int, groups: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, C), generator=gen, device="cuda") * 3.0
    pt = torch.rand((rows, C), generator=gen, device="cuda") * 0.998 + 0.001
    labels = torch.randint(-1, C + 1, (rows,), generator=gen, device="cuda", dtype=torch.int32)
    g = torch.rand((2, groups), generator=gen, device="cuda") + 0.5
    return x, pt, labels, g[0].contiguous(), g[1].contiguous()


def _short(name: str) -> str:
    """cls_losses_fwd_kernel<4, 0> from the mangled name (vec, spec)."""
    m = re.search(r"(cls_losses_(?:fwd|bwd|sum)_kernel)(?:ILi(\d+)ELi(\d+)E)?", name)
    return f"{m.group(1)}<{m.group(2)}, {m.group(3)}>" if m.group(2) else m.group(1)


def _sass_counts(lib_path) -> dict:
    """Static SASS instructions of each cls-loss kernel, all and MUFU."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = _short(m.group(1)) if "cls_losses" in m.group(1) else None
            if name:
                counts[name] = {"instructions": 0, "MUFU": 0}
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", ln):
            counts[name]["instructions"] += 1
            counts[name]["MUFU"] += "MUFU" in ln
    return counts


def _clock_under_load(fn, launches: int) -> str:
    """nvidia-smi's SM clock and power while `launches` calls of fn run."""
    for _ in range(launches):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return out.stdout.strip()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--groups", type=int, default=4)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_cls_losses needs a CUDA card")

    gpu = nvidia_smi_line()
    lib = _build.load_library()
    # ptxas prints "Compiling entry function '<name>'", then its stack, spills and registers
    regs, name = {}, None
    for ln in lib.log.splitlines():
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        elif name and "cls_losses" in name and ("registers" in ln or "spill" in ln):
            key = _short(name)
            regs[key] = (regs.get(key, "") + " " + ln.strip()).strip()
    vec_, spec_ = 4, K.GAMMA2_POW
    result = {"gpu": gpu, "batch": args.batch, "groups": args.groups, "ptxas": regs,
              "sass": _sass_counts(lib.path)}
    for k in sorted(regs):
        print(f"[ptxas] {k}: {regs[k]}; SASS {result['sass'].get(k)}", flush=True)

    g = args.groups
    rows = args.batch * P3_HW[0] * P3_HW[1] * ANCHORS
    x, pt, labels, gf, gd = _inputs(rows, g, args.seed)
    n = rows * C
    fwd = {"vec4 gamma2 PowSum on (main)": (vec_, spec_),
           "vec4 gamma2 PowSum off": (4, K.GAMMA2_NOPOW),
           "vec4 generic": (4, K.GENERIC), "vec1 gamma2 PowSum on": (1, spec_)}
    bwd = {"vec4 gamma2 (main)": (vec_, spec_), "vec4 generic": (4, K.GENERIC),
           "vec1 gamma2": (1, spec_)}
    flag_nopow = FLAGSHIP._replace(want_powsum=False)
    times = {}
    for what, (v, s) in fwd.items():
        pp = flag_nopow if s == K.GAMMA2_NOPOW else FLAGSHIP
        times[f"fwd {what}"] = _ms(lambda: K._launch_fwd(x, pt, labels, g, pp, v, s),
                                   args.iters)
    for what, (v, s) in bwd.items():
        times[f"bwd {what}"] = _ms(
            lambda: K._launch_bwd(x, pt, labels, gf, gd, FLAGSHIP, v, s), args.iters)
    dx = torch.empty_like(x)
    times["x.sum() + pt.sum() (8 B an element read)"] = _ms(lambda: (x.sum(), pt.sum()),
                                                             args.iters)
    times["torch.add(x, pt, out=dx) (8 B read + 4 B written)"] = _ms(
        lambda: torch.add(x, pt, out=dx), args.iters)
    result["P3"] = {
        "rows": rows, "elements": n, "ms": times,
        "fwd_bytes_ms_at_3.35TB/s": (8 * n + 4 * rows) / HBM_BYTES_PER_S * 1e3,
        "bwd_bytes_ms_at_3.35TB/s": (12 * n + 4 * rows) / HBM_BYTES_PER_S * 1e3,
        "fwd_clock_power_under_load": _clock_under_load(
            lambda: K._launch_fwd(x, pt, labels, g, FLAGSHIP, vec_, spec_), 3000),
        "bwd_clock_power_under_load": _clock_under_load(
            lambda: K._launch_bwd(x, pt, labels, gf, gd, FLAGSHIP, vec_, spec_), 3000),
    }
    for k, t in times.items():
        print(f"[P3] {k}: {t:.4f} ms", flush=True)

    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
