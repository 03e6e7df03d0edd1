"""Variants of the fixed-order contraction (``csrc/invariant_matmul.cu``)
and of its launch plan's tile, beside the shipped kernel, on one card.

    python3 tools/contract_variants.py

Each variant is a copy of ``src/repro_torch/csrc/`` with text edits to
``invariant_matmul.cu``, built into ``build/contract_variants/`` (an
ignored directory) and loaded in place of the shipped library
(``kernels.build.CSRC``). The variants:

* ``shipped``: the source as it is;
* ``fma``: the same order with each 8-wide k step's partial an f32 FMA
  chain on the CUDA cores (from zero, in k order) in place of the split
  TF32 products: the error of f32 FMAs in the same blocked order (its
  time is not that of a tuned FMA kernel);
* ``lolo``: the split TF32 step with a fourth product, lo x lo, first;
* ``cvt``: the TF32 rounding by ``cvt.rna.tf32.f32`` (``make_frag``)
  instead of integer ops (the same bits);
* ``onecta``: without the bound of 128 registers (one CTA of the
  128-row tile an SM);
* ``unroll``: the four k steps of a tile unrolled in the 128-row tile
  too (over the transposed key view it then spills);
* ``loraw``: lo = v - hi handed to the tensor core unrounded (it reads
  the TF32 bits of the register), 3 ALU ops a value instead of 5;
* ``trunc``: hi truncated (v with its 13 low bits cleared) and lo
  unrounded, 2 ALU ops a value;
* ``step16``: the split TF32 chain over 16-wide k steps (6 mma from
  zero) before each promotion, half the CUDA-core adds.

It prints, as ``[errors]`` lines, each variant's and cuBLAS's largest
error against the f64 product, and the variant's against cuBLAS over
max|ref| (phase 6b's and the ``cuda`` tests' gate is 1e-6), on f32 and
on bf16-valued operands; as ``[bits]`` lines whether a variant that
keeps the order gives the shipped bits; as ``[variants]`` and ``[tiles]``
lines the device time of each variant and of each forced tile at the
main path's shapes (CUDA events, L2 flushed, median of 30 as
``chip_smoke.time_ms``; the smaller of two rounds taken in turns).
Needs one CUDA card; the card's name and power limit come first.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import invariant_matmul as im  # noqa: E402

SRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "contract_variants"
STEP_START = "      // the step's three passes"
STEP_END = "part[i][j][e] += d[i][j][e];\n"
FMA_STEP = """      // the step on the CUDA cores: an f32 FMA chain from zero
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wr + 16 * i + gr + 8 * (e >> 1);
            const int q = wc + 8 * j + 2 * tc + (e & 1);
            float acc = 0.f;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              const float bv = KF ? sb[q * kRS + ks + kk]
                                  : sb[(ks + kk) * T::kQS + q];
              acc = fmaf(sa[r * kRS + ks + kk], bv, acc);
            }
            part[i][j][e] += acc;
          }
"""
EDITS = {
    "shipped": [],
    "fma": [("step", FMA_STEP)],
    "lolo": [("        for (int j = 0; j < NT; ++j) mma_zero(d[i][j], "
              "fa[i].l, fb[j].h);",
              "        for (int j = 0; j < NT; ++j) {\n"
              "          mma_zero(d[i][j], fa[i].l, fb[j].l);\n"
              "          smoe::mma_tf32(d[i][j], fa[i].l, fb[j].h);\n"
              "        }")],
    "cvt": [("  for (int i = 0; i < N; ++i) {\n"
             "    f.h[i] = tf32_rna(v[i]);\n"
             "    f.l[i] = tf32_rna(v[i] - __uint_as_float(f.h[i]));\n"
             "  }\n", "  smoe::make_frag<true>(f, v);\n")],
    "onecta": [("__launch_bounds__(kThreads, 2)",
                "__launch_bounds__(kThreads)")],
    "unroll": [("#pragma unroll(MT * NT >= 8 ? 1 : kTK / 8)\n",
                "#pragma unroll\n")],
    "loraw": [("    f.l[i] = tf32_rna(v[i] - __uint_as_float(f.h[i]));",
               "    f.l[i] = __float_as_uint(v[i] - "
               "__uint_as_float(f.h[i]));")],
    "trunc": [("    f.h[i] = tf32_rna(v[i]);\n"
               "    f.l[i] = tf32_rna(v[i] - __uint_as_float(f.h[i]));",
               "    f.h[i] = __float_as_uint(v[i]) & 0xffffe000u;\n"
               "    f.l[i] = __float_as_uint(v[i] - "
               "__uint_as_float(f.h[i]));")],
    "step16": [
        ("      // the step's three passes, each over every tile of the "
         "warp: MT NT\n"
         "      // independent chains in flight\n"
         "      float d[MT][NT][4];",
         "      float d[MT][NT][4];\n"
         "      if (ks % 16 == 8) {\n"
         "#pragma unroll\n"
         "        for (int i = 0; i < MT; ++i)\n"
         "#pragma unroll\n"
         "          for (int j = 0; j < NT; ++j)\n"
         "#pragma unroll\n"
         "            for (int e = 0; e < 4; ++e) "
         "d[i][j][e] = carry[i][j][e];\n"
         "      }"),
        ("        for (int j = 0; j < NT; ++j) mma_zero(d[i][j], fa[i].l, "
         "fb[j].h);",
         "        for (int j = 0; j < NT; ++j) {\n"
         "          if (ks % 16 == 8) "
         "smoe::mma_tf32(d[i][j], fa[i].l, fb[j].h);\n"
         "          else mma_zero(d[i][j], fa[i].l, fb[j].h);\n"
         "        }"),
        ("          for (int e = 0; e < 4; ++e) part[i][j][e] += "
         "d[i][j][e];",
         "          for (int e = 0; e < 4; ++e) {\n"
         "            if (ks % 16 == 8) part[i][j][e] += d[i][j][e];\n"
         "            else carry[i][j][e] = d[i][j][e];\n"
         "          }"),
        ("  float total[MT][NT][4], part[MT][NT][4];",
         "  float total[MT][NT][4], part[MT][NT][4], "
         "carry[MT][NT][4];")],
}
SAME_ORDER = ("cvt", "onecta", "unroll")


def variant_dir(name):
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(SRC, d)
    p = d / "invariant_matmul.cu"
    s = p.read_text()
    for old, new in EDITS[name]:
        if old == "step":
            i, j = s.index(STEP_START), s.index(STEP_END)
            s = s[:i] + new + s[j + len(STEP_END):]
        else:
            assert old in s, (name, old)
            s = s.replace(old, new)
    p.write_text(s)
    return d


def use(name, d):
    build.CSRC = d
    build.BUILD_DIR = OUT / f"lib_{name}"
    build._loaded.clear()


def error_cases(gen):
    """(label, fn, operands): the failing-prone gate shapes, f32 and
    bf16-valued."""
    q = torch.randn(8, 16, 576, generator=gen, device="cuda")
    k = torch.randn(8, 2048, 576, generator=gen, device="cuda")
    p = torch.softmax(torch.randn(8, 16, 2048, generator=gen,
                                  device="cuda"), -1)
    w = torch.randn(2048, 64, generator=gen, device="cuda") / 2048 ** 0.5
    x = torch.randn(2048, 1, 2048, generator=gen, device="cuda")
    (qb, kb), (pb, vb) = c.mla_attend_operands(torch, gen, 8, 2048)
    return [
        ("scores f32 (8, 16, 576) x (8, 576, 2048)", im.batched_contract,
         (q, k.transpose(1, 2))),
        ("values f32 (8, 16, 2048) x (8, 2048, 512)", im.batched_contract,
         (p, k[..., :512])),
        ("router f32 (2048, 1, 2048) x (2048, 64)", im.router_logits,
         (x, w)),
        ("scores bf16-valued (8, 16, 576) x (8, 576, 2048)",
         im.batched_contract, (qb, kb)),
        ("values bf16-valued (8, 16, 2048) x (8, 2048, 512)",
         im.batched_contract, (pb, vb)),
    ]


def timing_cases(gen):
    cases = []
    for d, e in ((1024, 32), (2048, 64)):
        w = torch.randn(d, e, generator=gen, device="cuda") / d ** 0.5
        for m in (8, 256, 2048, 16384):
            x = torch.randn(m, 1, d, generator=gen, device="cuda")
            cases.append((f"router d {d} e {e} M {m}", im.router_logits,
                          (x, w)))
    for s_q in (32, 256, 2048):
        for kind, ops in zip(("scores", "values"), c.mla_attend_operands(
                torch, gen, 1, 2048, h=16 * s_q)):
            cases.append((f"prefill {kind} {16 * s_q} rows",
                          im.batched_contract, ops))
    for kind, ops in zip(("scores", "values"),
                         c.mla_attend_operands(torch, gen, 8, 2048)):
        cases.append((f"decode {kind} 8 x 16 rows", im.batched_contract,
                      ops))
    return cases


def forced_plan(tile, plan):
    """``plan`` with tile ``tile`` and the split its grid calls for."""
    def p(n, P, K, Q, sa, sb, a_aligned=True, b_aligned=True):
        pl = plan(n, P, K, Q, sa, sb, a_aligned, b_aligned)
        bm, bn = im.TILES[tile]
        tiles = n * -(-P // bm) * -(-Q // bn)
        ns = (pl.n_chunks if 1 < pl.n_chunks <= im.MAX_SPLIT
              and tiles < im.FILL else 1)
        return pl._replace(tile=tile, n_split=ns,
                           grid=(-(-Q // bn) * ns, -(-P // bm), n))
    return p


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dirs = {name: variant_dir(name) for name in EDITS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs, times = error_cases(gen), timing_cases(gen)
    flush = torch.empty(64 * 2**20, device="cuda")
    shipped, res = {}, {}
    for rnd in range(2):
        for name, d in dirs.items():
            use(name, d)
            if rnd == 0:
                log = build.build(["invariant_matmul"])["invariant_matmul"]
                for line in log["log"].splitlines():
                    if "Compiling entry function" in line:
                        kname = c.kernel_label(line)
                    elif "registers" in line or "spill" in line:
                        print(f"[ptxas] {name} {kname}: {line.strip()}")
                for label, fn, ops in errs:
                    out = fn(*ops).double()
                    plain = (im.router_logits_ref if fn is im.router_logits
                             else im.batched_contract_ref)
                    cub = plain(*ops).double()
                    exact = plain(*(t.double() for t in ops))
                    mag = exact.abs().max().item()
                    print(f"[errors] {name} {label}: kernel vs f64 "
                          f"{(out - exact).abs().max().item():.3e}, cuBLAS "
                          f"vs f64 {(cub - exact).abs().max().item():.3e}, "
                          f"kernel vs cuBLAS / max|ref| "
                          f"{(out - cub).abs().max().item() / mag:.3e}",
                          flush=True)
            for label, fn, ops in times:
                if rnd == 0:
                    out = fn(*ops)
                    if name == "shipped":
                        shipped[label] = out
                    elif name in SAME_ORDER:
                        print(f"[bits] {name} {label}: the shipped bits "
                              f"{torch.equal(out, shipped[label])}")
                ms = c.time_ms(torch, lambda: fn(*ops), flush=flush)
                res.setdefault(label, {}).setdefault(name, []).append(ms)
    for label, v in res.items():
        print(f"[variants] {label}: " + "  ".join(
            f"{k} {min(t):.4f}" for k, t in v.items()) + " ms")
    use("shipped", dirs["shipped"])
    plan, tres = im._plan, {}
    try:
        for rnd in range(2):
            for tile in range(len(im.TILES)):
                im._plan = forced_plan(tile, plan)
                for label, fn, ops in times:
                    if rnd == 0 and not torch.equal(fn(*ops),
                                                    shipped[label]):
                        print(f"[bits] tile {tile} {label}: NOT the "
                              f"shipped bits")
                    ms = c.time_ms(torch, lambda: fn(*ops), flush=flush)
                    tres.setdefault(label, {}).setdefault(tile, []).append(
                        ms)
    finally:
        im._plan = plan
    for label, v in tres.items():
        print(f"[tiles] {label}: " + "  ".join(
            f"{im.TILES[k][0]} x {im.TILES[k][1]} {min(t):.4f}"
            for k, t in v.items()) + " ms")


if __name__ == "__main__":
    main()
