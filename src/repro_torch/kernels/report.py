"""What nvcc made of the port's kernels: registers, shared memory and spills
per kernel function from ``ptxas -v``, and the tensor-core and bulk-copy
instructions of each function's SASS (``HGMMA`` = wgmma, ``HMMA`` =
mma.sync, ``UBLKCP`` = cp.async.bulk, ``UTMALDG`` / ``UTMASTG`` = TMA tile
loads and stores) from ``cuobjdump -sass``.  Needs ``nvcc`` and
``cuobjdump``, not a card.

    PYTHONPATH=src python -m repro_torch.kernels.report [kernel ...]

Builds with the port's flags plus ``-Xptxas -v`` into
``kernels/_build/report/`` and prints one JSON object per kernel function.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import _build

KERNELS = (
    "bank_arbiter",
    "banked_copy",
    "paged_attention",
    "flash_attention",
    "flash_attention_bwd",
)
REPORT_DIR = _build.BUILD_DIR / "report"

_ENTRY = re.compile(r"Compiling entry function '(\S+)' for")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_SASS_FN = re.compile(r"Function : (\S+)")
#: SASS opcodes counted per function
SASS_OPS = ("HGMMA", "HMMA", "UBLKCP", "UTMALDG", "UTMASTG")


def _tool(name: str) -> str:
    cand = Path(_build._nvcc()).parent / name
    return str(cand) if cand.exists() else (shutil.which(name) or name)


def _demangle(names) -> dict:
    names = list(names)
    try:
        out = subprocess.run(
            [_tool("cu++filt")], input="\n".join(names), capture_output=True, text=True, timeout=60
        ).stdout.splitlines()
    except OSError:
        return {n: n for n in names}
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def ptxas_stats(log: str) -> dict:
    """``{mangled function: {registers, smem_bytes, stack, spill_stores, spill_loads,
    warnings}}``; ``warnings`` holds ptxas's notes on the function (such as
    wgmma instructions it had to serialize)."""
    stats, fn = {}, None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            fn = m.group(1)
            stats.setdefault(fn, {"warnings": []})
        elif "wgmma" in line and (named := re.search(r"function '(\S+)'", line)):
            stats.setdefault(named[1], {"warnings": []})["warnings"].append(line.strip())
        elif fn and (m := _PROPS.search(line)):
            stats[fn].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif fn and (m := _USED.search(line)):
            stats[fn].update(registers=int(m[1]), smem_bytes=int(m[2] or 0))
    return stats


def sass_counts(lib: Path) -> dict:
    """``{mangled function: {opcode: n}}`` of ``SASS_OPS`` from the library's SASS."""
    sass = subprocess.run(
        [_tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True, check=True
    ).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if m := _SASS_FN.search(line):
            fn = m.group(1)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


def report(names=KERNELS) -> list:
    log: dict = {}
    paths = _build.build(names, extra_flags=("-Xptxas", "-v"), build_dir=REPORT_DIR, log=log)
    rows = []
    for name in names:
        stats = ptxas_stats(log.get(name, ""))
        counts = sass_counts(paths[name])
        pretty = _demangle(sorted(set(stats) | set(counts)))
        for fn in sorted(set(stats) | set(counts)):
            rows.append(
                {"kernel": name, "function": pretty[fn], **stats.get(fn, {}), **counts.get(fn, {})}
            )
    return rows


def main(argv) -> int:
    shutil.rmtree(REPORT_DIR, ignore_errors=True)  # ptxas prints only while compiling
    for row in report(tuple(argv) or KERNELS):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
