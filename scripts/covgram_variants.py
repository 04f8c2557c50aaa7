"""Time variants of a checkout's covgram kernel on one card, to split its time
into the FMAs and the stores of S.

    python3 scripts/covgram_variants.py --tree parent=build/parent --tree change=. \\
        --out chiprun_out/covgram_variants.txt

For each checkout, the variants are made at run time from its
``src/repro_torch/csrc/covgram.cu`` (none is kept) and built with nvcc into
a library of their own:

- ``as_is``: the kernel as it stands;
- ``sink``: the stores of S replaced by a sink that keeps every sum live
  (one store of their sum when it equals a value it never takes);
- ``no_fma``: the FMAs removed (the staging and the stores remain);
- ``ieee_division`` (a kernel with ``div_n_steps`` only): the IEEE division
  in place of the correction steps.

Each is timed with CUDA events at (n, p) = (80, 16000), float32 and bf16,
in turns over the checkouts (each variant twice, in the order given and
back); the sha256 of S is printed for the variants that compute it, and
``fill`` gives the card's rate for writing the same 1.024 GB
(``Tensor.fill_``).  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.build import NVCC_FLAGS, nvcc  # noqa: E402

N, P = 80, 16000
REPS = 20
FMA = re.compile(r"acc\[a\]\[b\] = fmaf\(av\[a\], bv\[b\], acc\[a\]\[b\]\);")
# where each known kernel's epilogue starts, and how its tile ends early
EPILOGUES = (
    ("    // divided by n:", "continue;"),     # persistent tiles
    ("  // in place: each thread writes", "return;"),  # one tile a block
)
SINK = """  {{
    float sink = 0.0f;
    const float* flat = &acc[0][0];
    for (int i = 0; i < (int)(sizeof(acc) / sizeof(float)); ++i) sink += flat[i];
    if (sink == 1.2345e-30f) S[0] = sink;
    {exit}
  }}
"""


def variants(src: str) -> dict[str, str]:
    if len(FMA.findall(src)) < 1:
        raise ValueError("covgram_variants: no FMA statement found")
    out = {"as_is": src, "no_fma": FMA.sub("(void)0;", src)}
    for marker, exit_ in EPILOGUES:
        if marker in src:
            out["sink"] = src.replace(marker, SINK.format(exit=exit_) + marker, 1)
            break
    else:
        raise ValueError("covgram_variants: no known epilogue marker found")
    steps = "acc[a][b] = div_n_steps(acc[a][b], fn, inv_n);"
    if steps in src:
        out["ieee_division"] = src.replace(steps, "acc[a][b] = acc[a][b] / fn;")
    return out


def build(label: str, name: str, src: str, workdir: Path) -> ctypes.CDLL:
    cu = workdir / f"{label}_{name}.cu"
    so = workdir / f"lib{label}_{name}.so"
    cu.write_text(src)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-shared", str(cu), "-o", str(so)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {label} {name}:\n{r.stdout}{r.stderr}")
    regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", r.stdout + r.stderr)})
    print(f"[variant_build] tree={label} variant={name} registers={regs}", flush=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("covgram_launch_f32", "covgram_launch_bf16"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def timed(fn) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / REPS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, metavar="LABEL=DIR",
                    help="a checkout holding src/repro_torch/csrc/covgram.cu (repeatable)")
    ap.add_argument("--out", type=Path, help="file that collects every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("covgram_variants: CUDA is not available")
    trees = dict(t.split("=", 1) for t in args.tree)
    lines: list[str] = []

    def emit(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    emit(f"[variant_card] {card}")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for label, tree in trees.items():
            src = (ROOT / tree / "src/repro_torch/csrc/covgram.cu").read_text()
            for name, text in variants(src).items():
                libs[(label, name)] = build(label, name, text, Path(tmp))
        g = torch.Generator(device="cuda").manual_seed(0)
        x32 = torch.randn((N, P), device="cuda", generator=g) + 3.0
        xs = {"float32": x32, "bfloat16": x32.to(torch.bfloat16)}
        S = torch.empty((P, P), device="cuda")
        emit(f"[variant_fill] bytes={S.numel() * 4} ms={timed(lambda: S.fill_(1.0)):.4f}")
        stream = torch.cuda.current_stream().cuda_stream
        order = list(libs) + list(reversed(libs))
        for dtype, x in xs.items():
            mu = torch.mean(x, dim=0, dtype=torch.float32)
            suffix = "f32" if dtype == "float32" else "bf16"
            for label, name in order:
                fn = getattr(libs[(label, name)], f"covgram_launch_{suffix}")

                def call():
                    status = fn(x.data_ptr(), mu.data_ptr(), S.data_ptr(), N, P, stream)
                    if status != 0:
                        raise RuntimeError(f"{label} {name}: CUDA error {status}")
                S.fill_(float("nan"))
                ms = timed(call)
                digest = ""
                if name in ("as_is", "ieee_division"):
                    digest = " sha256=" + hashlib.sha256(S.cpu().numpy().tobytes()).hexdigest()[:16]
                emit(f"[variant] tree={label} variant={name} dtype={dtype} n={N} p={P} "
                     f"ms={ms:.4f}{digest}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
