"""Instructions a butterfly of the NTT kernels' passes, from the built SASS.

    python tools/ntt_sass.py [--out PATH] [--b4 | --b5 | --b6 [--old PATH]] [--nvcc-flag FLAG ...]

Builds (or loads) the port's kernel libraries (``csrc/ntt.cu``, one for each
N, through ``ops/ntt_cuda.build()``), disassembles them with
``cuobjdump -sass`` and,
for each kernel (``ntt_fwd_kernel<log2 N, C>``, ``ntt_bwd_kernel<...>``),
finds its pass bodies: a pass is the unrolled code of one group of 2^R
words (R stages in registers), either the body of a loop over groups (an
innermost loop: a branch back to an earlier address, with no other such
branch inside) or, where a thread has one group, the straight code between
two barriers.  A pass body's Shoup products are its high multiplies
(``IMAD.HI``): one a butterfly, plus one a word where the pass applies
N^-1.  For each body it prints the instructions, the products and the
instructions a product; the hot pass of a kernel is its body with the most
products (R = 4, no N^-1: 32 butterflies), and its instructions a butterfly
are the figure to hold against the 7 operations of a butterfly.  Registers
and spills come from ptxas's report in the build log beside each library.

``--b4``: the same for kernel B4 (``csrc/ntt64.cu``, ``ntt64_fwd_kernel``,
``ntt64_bwd_kernel``).  Its 64-bit products compile to wide multiplies
(``IMAD.WIDE.U32``), not ``IMAD.HI``, so a pass body is found by its
shared-memory traffic instead: an innermost loop with as many 64-bit
shared loads as stores, 2^R each, is a loop over groups, one an
iteration, and holds R 2^R / 2 butterflies (R <= 3; a pass that reads or
writes the row in device memory is not counted); the hot pass is the body
with the most butterflies (R = 3: 12), the longest of those
(``hot_pass64``).  Where a thread takes at most two groups of a pass (the
clusters of 8 and 16 at N = 2^14) the passes are unrolled straight code,
not loops, and the kernel reports no pass: its C = 1 kernel, which loops,
is the one to read.
``--b5``: kernel B5 (``csrc/ntt3n.cu``, ``ntt3n_fwd_kernel<C>``,
``ntt3n_bwd_kernel<C>`` for each cluster size C, one library for all N).
Its passes are loops over groups held in registers (``b5_passes``): a loop
with 2^R 64-bit shared loads and as many stores is a radix-2^R pass of
R 2^R / 2 butterflies (R <= 3), one with 3 of each a radix-3 pass of one
radix-3 butterfly (3 products); the hot radix-2^k pass is the one with the
most butterflies (R = 3: 12).  Its instructions a butterfly, and a radix-3
butterfly, are the kernel's own cost, held beside the 15 multiply-adds of
a Shoup product (``chip_smoke.py``'s bound).
``--b6``: kernel B6 (``csrc/ntt_sharded.cu``, ``tiled_kernel<threads, cn>``
and ``simple_kernel``; one library for all N), and with ``--old PATH`` another
version of its source too (the parent's ``local_step_kernel``, written by
``git show``).  A loop of a product is an innermost loop whose shared (or
generic) loads feed 64-bit wide multiplies (``IMAD.WIDE``, at least one a
word loaded); its multiply-accumulates are the words it loads over
the words a MAC of the kernel's layout (``b6_words_a_mac``: (2 + cn) /
(2 cn) for the tiled kernel's 2 x cn tiles, 2 + cn words a term of 2 cn
MACs; 2 for the parent's one output a thread).  The tiled kernel's step-2 loops read their
left pair with 16-byte loads only (``LDS.128``), its step-1 loops A's rows
with 8-byte ones; the parent's step 1 comes before its step 2.  The hot
loop of each product is its loop with the most MACs; its instructions a
MAC are the kernel's cost, held beside the 8 multiply-adds a MAC of
``chip_smoke.py``'s bound.
``--nvcc-flag FLAG`` (repeatable): build the libraries again with FLAG
added to the port's flags, into a temporary directory, and print ptxas's
registers and spills for each kernel beside the as-built ones (a register
cap such as ``-maxrregcount=64`` shows whether ptxas's own register target
is what spills).
The full disassembly goes to ``--out`` (by default beside the libraries, in
``matrix_fhe_tpu_torch/_build/``).  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``); no GPU and no jax.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from matrix_fhe_tpu_torch.ops import ntt_cuda  # noqa: E402

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_KERNEL = re.compile(r"(ntt(?:64)?_(?:fwd|bwd)_kernel)ILi(\d+)ELi(\d+)E(?:Lb([01])E)?")
_KERNEL3N = re.compile(r"(ntt3n_(?:fwd|bwd)_kernel)(?:ILi(\d+)E)?")
_KERNEL6 = re.compile(r"(tiled_kernel|simple_kernel|local_step_kernel)(?:ILi(\d+)ELi(\d+)E)?")


def b6_words_a_mac(name: str) -> float | None:
    """Shared words a MAC of a B6 kernel's hot loops (None: not a B6 kernel
    with MAC loops)."""
    if name.startswith("tiled_kernel<"):
        cn = int(name[:-1].split(", ")[1])
        return (2 + cn) / (2 * cn)
    return 2 if name == "local_step_kernel" else None


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(ntt_cuda._nvcc()).parent / "cuobjdump")


def label(mangled: str) -> str:
    """``ntt_fwd_kernel<14, 1>``, ``ntt64_fwd_kernel<14, 8, ci>`` (B4's CI
    mode) or ``ntt3n_fwd_kernel<8>`` for a mangled kernel name."""
    m = _KERNEL.search(mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}, {m.group(3)}{', ci' if m.group(4) == '1' else ''}>"
    m = _KERNEL3N.search(mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)
    m = _KERNEL6.search(mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}, {m.group(3)}>" if m.group(2) else m.group(1)
    return mangled


def parse(sass: str) -> dict[str, list[tuple[int, str]]]:
    """kernel label -> its (address, instruction) pairs."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in sass.splitlines():
        if m := _FUNC.match(line):
            cur = label(m.group(1))
            funcs[cur] = []
        elif cur and (m := _INSTR.match(line)):
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    return funcs


def _unpredicated(text: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", text)


def opcode(text: str) -> str:
    return _unpredicated(text).split(" ")[0]


def loops(instrs: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(first, last) addresses of the innermost loops: from a backward
    branch's target to the branch, holding no other backward branch."""
    spans = []
    for addr, text in instrs:
        m = re.fullmatch(r"BRA\S* (0x[0-9a-f]+)", _unpredicated(text))
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    return [(lo, hi) for lo, hi in spans
            if not any(lo <= end < hi for _, end in spans)]


def _is_barrier(op: str) -> bool:
    return op.startswith("BAR") or "CGABAR" in op


def passes(instrs: list[tuple[int, str]]) -> list[list[str]]:
    """Opcodes of each pass body (see the module's docstring)."""
    def products(body):
        return sum(op.startswith("IMAD.HI") for op in body)

    spans = loops(instrs)
    bodies = [[opcode(t) for a, t in instrs if lo <= a <= hi] for lo, hi in spans]
    bodies = [b for b in bodies if products(b)]
    in_loop = {a for lo, hi in spans for a, _ in instrs if lo <= a <= hi}
    segment: list[str] = []
    for addr, text in instrs:
        op = opcode(text)
        if _is_barrier(op) or addr in in_loop:
            if products(segment):
                bodies.append(segment)
            segment = []
        else:
            segment.append(op)
    return bodies


def hot_pass(instrs: list[tuple[int, str]]) -> tuple[int, int]:
    """(instructions, Shoup products) of the pass body with the most
    products; (0, 0) if the kernel has none."""
    best = max(passes(instrs), key=lambda b: sum(op.startswith("IMAD.HI") for op in b),
               default=[])
    return len(best), sum(op.startswith("IMAD.HI") for op in best)


def hot_pass64(instrs: list[tuple[int, str]]) -> tuple[int, int]:
    """(instructions, butterflies) of B4's hot pass (see the module's
    docstring); (0, 0) if the kernel has none."""
    best = (0, 0)
    for lo, hi in loops(instrs):
        body = [opcode(t) for a, t in instrs if lo <= a <= hi]
        words = sum(op.startswith("STS") for op in body)
        if words < 4 or words != sum(op.startswith("LDS") for op in body):
            continue
        r = words.bit_length() - 1
        best = max(best, (r * words // 2, len(body)))
    return best[1], best[0]


def b5_passes(instrs: list[tuple[int, str]]) -> dict[str, tuple[int, int]]:
    """{"radix-2^k": (instructions, butterflies), "radix-3": (instructions,
    radix-3 butterflies)} of B5's hot radix-2^k pass and its radix-3 pass
    (see the module's docstring); a kind the kernel lacks is (0, 0)."""
    out = {"radix-2^k": (0, 0), "radix-3": (0, 0)}
    for lo, hi in loops(instrs):
        body = [opcode(t) for a, t in instrs if lo <= a <= hi]
        words = sum(op.startswith("STS") for op in body)
        if words != sum(op.startswith("LDS") for op in body):
            continue
        if words == 3:
            out["radix-3"] = max(out["radix-3"], (len(body), 1), key=lambda v: v[0])
        elif words >= 2 and words & (words - 1) == 0:
            r = words.bit_length() - 1
            cur = out["radix-2^k"]
            if (r * words // 2, -len(body)) > (cur[1], -cur[0]):
                out["radix-2^k"] = (len(body), r * words // 2)
    return out


def _lds_words(op: str) -> float:
    """64-bit words a shared or generic load reads (``LDS``, ``LDS.64``,
    ``LD.E.128``, ...): a stage read through a generic pointer counts too."""
    if not (op.startswith("LDS") or op.startswith("LD.")):
        return 0
    bits = re.search(r"\.(64|128)", op)
    return int(bits.group(1)) / 64 if bits else 0.5


def b6_loops(name: str, instrs: list[tuple[int, str]]) -> dict[str, dict]:
    """{"step 1": ..., "step 2": ...}: B6's hot loop of each product (see the
    module's docstring), each {"instructions", "macs", "wide", "mix"}; a
    product with no loop found is left out."""
    base = name.split("<")[0]
    per_mac = b6_words_a_mac(name)
    if per_mac is None:
        return {}
    found = []
    for lo, hi in loops(instrs):
        body = [opcode(t) for a, t in instrs if lo <= a <= hi]
        words = sum(_lds_words(op) for op in body)
        wide = sum(op.startswith("IMAD.WIDE") for op in body)
        if words and wide >= words:
            found.append((lo, body, words / per_mac, wide))
    if not found:
        return {}
    if base == "tiled_kernel":
        steps = {"step 1": [f for f in found if any(op.startswith("LDS.64") for op in f[1])],
                 "step 2": [f for f in found if not any(op.startswith("LDS.64") for op in f[1])]}
    else:
        found.sort(key=lambda f: f[0])
        steps = {"step 1": found[:1], "step 2": found[-1:]}
    out = {}
    for step, fs in steps.items():
        if fs:
            _, body, macs, wide = max(fs, key=lambda f: f[2])
            out[step] = {"instructions": len(body), "macs": macs, "wide": wide,
                         "mix": collections.Counter(body).most_common(8)}
    return out


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """kernel label -> registers and spill bytes, from ``nvcc -Xptxas -v``."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?$",
                          line.strip()):
            cur = label(m.group(1))
            out.setdefault(cur, {})
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out[cur]["registers"] = int(m.group(1))
    return out


def disassemble(logns=ntt_cuda.LOGNS, source=ntt_cuda.SOURCE) -> str:
    """SASS of the libraries of ``source`` for the sizes ``logns``, built
    first if missing."""
    ntt_cuda.build(logns, source)
    return "".join(
        subprocess.run([_cuobjdump(), "-sass", str(ntt_cuda.library_path(logn, source))],
                       capture_output=True, text=True, check=True, timeout=300).stdout
        for logn in logns)


def build_logs(logns=ntt_cuda.LOGNS, source=ntt_cuda.SOURCE) -> str:
    return "".join(ntt_cuda.library_path(logn, source).with_suffix(".log").read_text()
                   for logn in logns)


def ptxas_with(logns, source, flags) -> dict[str, dict[str, int]]:
    """ptxas's registers and spills of ``source`` built for ``logns`` with
    the port's flags and ``flags``; nothing is kept."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [subprocess.run([ntt_cuda._nvcc(), *ntt_cuda.NVCC_FLAGS, *flags,
                                f"-DMFHE_NTT_LOGN={logn}", "-o", f"{tmp}/{logn}.so", str(source)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                               check=True, timeout=600).stdout
                for logn in logns]
    return ptxas_report("".join(logs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ntt_cuda.BUILD_DIR / "ntt_sass.txt"))
    ap.add_argument("--b4", action="store_true", help="kernel B4, csrc/ntt64.cu")
    ap.add_argument("--b5", action="store_true", help="kernel B5, csrc/ntt3n.cu")
    ap.add_argument("--b6", action="store_true", help="kernel B6, csrc/ntt_sharded.cu")
    ap.add_argument("--old", default=None, help="with --b6: another B6 source")
    ap.add_argument("--nvcc-flag", action="append", default=[],
                    help="build again with this flag added, and print ptxas's report")
    args = ap.parse_args()
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda, ntt64_cuda, ntt_sharded_cuda
    if args.b6:
        return main_b6(args, ntt_sharded_cuda)
    source, logns = (ntt64_cuda.SOURCE, ntt64_cuda.LOGNS) if args.b4 else \
        (ntt3n_cuda.SOURCE, [ntt3n_cuda.BUILD_KEY]) if args.b5 else \
        (ntt_cuda.SOURCE, ntt_cuda.LOGNS)
    sass = disassemble(logns, source)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(sass)
    print(f"SASS of {ntt_cuda.library_path(logns[-1], source).name} and the other sizes -> {out}")
    regs = ptxas_report(build_logs(logns, source))
    for name, instrs in sorted(parse(sass).items()):
        r = regs.get(name, {})
        if args.b5:
            hot = "; ".join(f"{kind} pass {n} instructions / {p} butterflies = {n / p:.2f} a "
                            f"butterfly" if p else f"no {kind} pass"
                            for kind, (n, p) in b5_passes(instrs).items())
            print(f"{name}: {len(instrs)} instructions, {r.get('registers', '?')} registers, "
                  f"{r.get('spill_bytes', '?')} spill bytes; {hot}")
            if args.nvcc_flag:
                w = ptxas_with(logns, source, args.nvcc_flag).get(name, {})
                print(f"  with {' '.join(args.nvcc_flag)}: {w.get('registers', '?')} registers, "
                      f"{w.get('spill_bytes', '?')} spill bytes")
            continue
        n, p = (hot_pass64 if args.b4 else hot_pass)(instrs)
        hot = f"hot pass {n} instructions / {p} butterflies = {n / p:.2f} a butterfly" if p else "no pass"
        print(f"{name}: {len(instrs)} instructions, {r.get('registers', '?')} registers, "
              f"{r.get('spill_bytes', '?')} spill bytes; {hot}")
        for body in passes(instrs):
            prods = sum(op.startswith("IMAD.HI") for op in body)
            mix = ", ".join(f"{op} {c}" for op, c in collections.Counter(body).most_common(8))
            print(f"  pass of {len(body)} instructions, {prods} Shoup products, "
                  f"{len(body) / prods:.2f} a product: {mix}")
    return 0


def main_b6(args, ntt_sharded_cuda) -> int:
    sources = {"": ntt_sharded_cuda.SOURCE}
    if args.old:
        sources["old "] = Path(args.old).resolve()
    key = [ntt_sharded_cuda.BUILD_KEY]
    texts = []
    for tag, source in sources.items():
        sass = disassemble(key, source)
        texts.append(sass)
        regs = ptxas_report(build_logs(key, source))
        for name, instrs in sorted(parse(sass).items()):
            r = regs.get(name, {})
            print(f"{tag}{name} ({source.name}): {len(instrs)} instructions, "
                  f"{r.get('registers', '?')} registers, {r.get('spill_bytes', '?')} spill bytes")
            for step, h in b6_loops(name, instrs).items():
                mix = ", ".join(f"{op} {c}" for op, c in h["mix"])
                print(f"  {step} hot loop: {h['instructions']} instructions / {h['macs']:g} MACs "
                      f"= {h['instructions'] / h['macs']:.2f} a MAC ({h['wide']} wide "
                      f"multiplies, {h['wide'] / h['macs']:.2f} a MAC): {mix}")
            if args.nvcc_flag:
                w = ptxas_with(key, source, args.nvcc_flag).get(name, {})
                print(f"  with {' '.join(args.nvcc_flag)}: {w.get('registers', '?')} registers, "
                      f"{w.get('spill_bytes', '?')} spill bytes")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(texts))
    print(f"SASS -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
