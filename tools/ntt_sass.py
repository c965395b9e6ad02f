"""Instruction count of the NTT kernels' butterfly loops, from the built SASS.

    python tools/ntt_sass.py [--out PATH]

Builds (or loads) the port's kernel library (``csrc/ntt.cu``, through
``ops/ntt_cuda.library()``), disassembles it with ``cuobjdump -sass`` and,
for each kernel, finds the innermost loops (a branch back to an earlier
address, with no other such branch inside) and prints each one's length and
mix of opcodes.  A butterfly loop is one with a high multiply (``IMAD.HI``)
that stores two shared-memory words a butterfly (``STS``): for it the
instructions per butterfly are printed too.  The full disassembly goes to
``--out`` (by default beside the library, in ``matrix_fhe_tpu_torch/_build/``).
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); no GPU and no
jax.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from matrix_fhe_tpu_torch.ops import ntt_cuda  # noqa: E402

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(ntt_cuda._nvcc()).parent / "cuobjdump")


def parse(sass: str) -> dict[str, list[tuple[int, str]]]:
    """kernel name -> its (address, instruction) pairs."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in sass.splitlines():
        if m := _FUNC.match(line):
            cur = m.group(1)
            funcs[cur] = []
        elif cur and (m := _INSTR.match(line)):
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    return funcs


def _unpredicated(text: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", text)


def opcode(text: str) -> str:
    return _unpredicated(text).split(" ")[0]


def loops(instrs: list[tuple[int, str]]):
    """Instruction lists of the innermost loops: from a backward branch's
    target address to the branch, holding no other backward branch."""
    spans = []
    for addr, text in instrs:
        m = re.fullmatch(r"BRA\S* (0x[0-9a-f]+)", _unpredicated(text))
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    for lo, hi in spans:
        if not any(lo <= end < hi for _, end in spans):
            yield [t for a, t in instrs if lo <= a <= hi]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ntt_cuda.BUILD_DIR / "ntt_sass.txt"))
    args = ap.parse_args()
    so = ntt_cuda.library_path()
    ntt_cuda.library()
    sass = subprocess.run([_cuobjdump(), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(sass)
    print(f"SASS of {so.name} -> {out}")
    for name, instrs in parse(sass).items():
        print(f"{name}: {len(instrs)} instructions")
        for loop in loops(instrs):
            body = [opcode(t) for t in loop]
            mulhi = any(op.startswith("IMAD.HI") for op in body)
            flies = sum(op.startswith("STS") for op in body) // 2 if mulhi else 0
            mix = ", ".join(f"{op} {c}" for op, c in collections.Counter(body).most_common())
            per = (f"{flies} butterflies, {len(body) / flies:.2f} a butterfly; "
                   if flies else "")
            print(f"  loop of {len(body)} instructions: {per}{mix}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
