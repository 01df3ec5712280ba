"""Static instruction counts of the hand-written kernels, read from SASS.

    python -m griduniverse_tpu_torch.tools.sass_counts [OUT_DIR]

From the root of a checkout, on a machine with nvcc and `cuobjdump` (both of
the CUDA toolkit). It builds the kernels' library if needed, disassembles it
with `cuobjdump -sass` and
prints, for every kernel, one line: the number of SASS instructions, and
every loop (a branch to an earlier address) as `first-last:count`, the
instructions between the branch's target and the branch, both included. A
loop's count is what one warp issues in one pass if it enters every side of
every branch inside, so it is an upper estimate of the thread-instructions
of one pass. With OUT_DIR it also writes each kernel's listing there, one
file a kernel, each instruction on a line with its index.

These counts stand behind the `INSTR_*` constants from which `chip_smoke.py`
reckons each kernel's `bound_ms`: the step loops of K1, K2 and K5–K7 and the
passes of K8a (`per_score_kernel`; the histogram, compaction and sort loops
of `per_select_kernel`). K3's and K11's bounds rest on their functions' own
operations (`chip_smoke.k3_function_ops`, `k11_function_ops`); their loops
here show what the walks issue.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_KERNEL_NAME = re.compile(r"\w+_kernel(?:<[^>]*>)?")
_BRANCH = re.compile(r"\bBRA(?:\.\w+)*\s+(?:\w+,\s*)?`?\(?(0x[0-9a-f]+)")


def find_cuobjdump(nvcc: str) -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    beside = Path(nvcc).resolve().parent / "cuobjdump"
    if beside.is_file():
        return str(beside)
    raise RuntimeError("cuobjdump not found on PATH or beside nvcc")


def parse_sass(text: str) -> dict[str, list[tuple[int, str]]]:
    """{mangled kernel name: [(address, instruction text), ...]}."""
    kernels: dict[str, list[tuple[int, str]]] = {}
    current = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = kernels.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return kernels


def loops(instrs: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(index of the first, index of the last instruction) of every loop."""
    index_of = {addr: i for i, (addr, _) in enumerate(instrs)}
    found = []
    for i, (addr, text) in enumerate(instrs):
        m = _BRANCH.search(text)
        if m:
            target = int(m.group(1), 16)
            if target <= addr and target in index_of:
                found.append((index_of[target], i))
    return found


def main() -> None:
    from griduniverse_tpu_torch.kernels import build

    nvcc = build.find_nvcc()
    build.load()  # builds the library if it is not there yet
    path = build.library_path()
    text = subprocess.run(
        [find_cuobjdump(nvcc), "-sass", str(path)], check=True, capture_output=True, text=True,
    ).stdout
    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    demangle = shutil.which("cu++filt") or str(Path(nvcc).resolve().parent / "cu++filt")
    for name, instrs in parse_sass(text).items():
        shown = name
        if Path(demangle).is_file():
            shown = subprocess.run([demangle, name], capture_output=True, text=True).stdout.strip() or name
        m = _KERNEL_NAME.search(shown)
        short = re.sub(r"\W+", "_", m.group(0)).strip("_") if m else name
        # the tail of every kernel is padding: a branch to itself and NOPs
        body = [(a, t) for a, t in instrs if not t.startswith("NOP")]
        spans = [(first, last) for first, last in loops(body) if last > first]
        print(f"sass {short}: {len(body)} instructions; loops "
              + (", ".join(f"{first}-{last}:{last - first + 1}" for first, last in spans) or "none"))
        if out_dir is not None:
            (out_dir / f"{short}.sass").write_text(
                f"{shown}\n" + "".join(f"{i:5d}  {a:06x}  {t}\n" for i, (a, t) in enumerate(body)))


if __name__ == "__main__":
    main()
