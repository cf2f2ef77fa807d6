"""Registers, spills and spill sites of the port's CUDA kernels, per
instantiation, on a machine with the CUDA toolkit.

Compiles each ``csrc/<name>.cu`` of a tree to a cubin with the flags of
``kernels/build.py`` plus line info (one ``nvcc`` a source, all started
together) and prints one JSON line per instantiation: registers, spill
bytes stored and loaded, and the blocks an SM holds by registers and by
shared memory (``analysis.smem.card_budgets``).  For an instantiation
that spills, ``sites`` counts its local-memory instructions (``STL``,
``LDL``) by the source line ``nvdisasm -g`` gives them.  Exits 1 if any
instantiation spills.

    python3 tools/ptxas_probe.py                  # this tree's sources
    python3 tools/ptxas_probe.py --csrc DIR ivf_block_topk pq_adc
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import smem  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

# nvcc's flags for a cubin: the library build's, without the host side
CUBIN_FLAGS = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]


def _tool(name: str) -> str:
    return shutil.which(name) or str(Path(build._nvcc()).parent / name)


def compile_cubins(csrc: Path, names: list[str], out: Path, extra: list[str]) -> dict:
    """{name: (ptxas log, cubin path)}; raises if a build fails."""
    procs = []
    for name in names:
        cubin = out / f"{name}.cubin"
        cmd = [build._nvcc(), "-cubin", "-lineinfo", *CUBIN_FLAGS, *extra,
               "-Xptxas", "-warn-spills", "-o", str(cubin), str(csrc / f"{name}.cu")]
        procs.append((name, cubin, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    done = {}
    for name, cubin, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        done[name] = (log, cubin)
    return done


def spill_sites(cubin: Path) -> dict:
    """{instance: Counter('STL@file:line' -> count)} from nvdisasm's
    line-annotated listing."""
    text = subprocess.run([_tool("nvdisasm"), "-c", "-g", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    sites: dict = collections.defaultdict(collections.Counter)
    fn, where = None, "?"
    for line in text.splitlines():
        m = re.search(r"\.section\s+\.text\.(\S+?),", line)
        if m:
            fn = smem.instance(m.group(1))
            continue
        m = re.search(r'//## File "([^"]+)", line (\d+)', line)
        if m:
            where = f"{Path(m.group(1)).name}:{m.group(2)}"
            continue
        m = re.search(r"\b(STL|LDL)(\.[\w.]+)?\s", line)
        if m and fn:
            sites[fn][f"{m.group(1)}@{where}"] += 1
    return sites


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="sources (default: all in --csrc)")
    ap.add_argument("--csrc", type=Path, default=build.CSRC,
                    help="the kernel sources to build (default: this tree's)")
    ap.add_argument("--nvcc-flag", action="append", default=[],
                    help="one more nvcc flag (repeatable)")
    args = ap.parse_args(argv)
    names = args.names or sorted(p.stem for p in args.csrc.glob("*.cu"))
    spilling = 0
    with tempfile.TemporaryDirectory() as tmp:
        built = compile_cubins(args.csrc, names, Path(tmp), args.nvcc_flag)
        for name, (log, cubin) in built.items():
            rows = smem.ptxas_rows(name, log)
            sites = spill_sites(cubin)
            for b in smem.card_budgets(rows):
                spills = b["spill_stores"] or b["spill_loads"]
                spilling += bool(spills)
                rec = {k: b[k] for k in ("source", "entry", "registers", "spill_stores",
                                         "spill_loads", "blocks_by_regs", "blocks_by_smem")}
                if spills:
                    rec["sites"] = dict(sorted(sites.get(b["entry"], {}).items()))
                print(json.dumps(rec), flush=True)
    print(json.dumps({"csrc": str(args.csrc), "sources": len(names),
                      "spilling": spilling}), flush=True)
    return 1 if spilling else 0


if __name__ == "__main__":
    sys.exit(main())
