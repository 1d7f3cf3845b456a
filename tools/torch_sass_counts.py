#!/usr/bin/env python3
"""What the compiler made of the half instances of the DIA and stencil
kernels: builds ``primme_tpu_torch/csrc/dia.cu`` and ``stencil3d.cu`` of
one or more checkouts with the package's ``nvcc`` flags plus ``-Xptxas
-v`` (registers, spills), disassembles each library (``cuobjdump -sass``,
names demangled with ``cu++filt``) and counts, for every kernel instance
whose name holds a half type, its instructions by kind: conversions
(``F2F``, ``F2FP``, ``I2F``, ``F2I``), half widenings (``HADD2.F32``),
packed half arithmetic (``HADD2``, ``HMUL2``, ``HFMA2``), f32 arithmetic
(``FADD``, ``FMUL``, ``FFMA``), byte permutes (``PRMT``), loads
(``LDG``) and stores (``STG``), and the whole. Prints one line per
instance; with ``--json PATH`` writes them there. Needs the CUDA toolkit
(the machine with the card).

Run: ``python3 tools/torch_sass_counts.py [--repo DIR ...] [--json
PATH]`` (default: this checkout).
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("dia", "stencil3d")
KINDS = {
    "conversions": re.compile(r"^(F2F|F2FP|I2F|F2I)\b"),
    "half_widenings": re.compile(r"^HADD2\.F32\b"),
    "packed_half": re.compile(r"^(HADD2|HMUL2|HFMA2)(\.BF16\w*)?$"),
    "f32_arithmetic": re.compile(r"^(FADD|FMUL|FFMA)\b"),
    "byte_permutes": re.compile(r"^PRMT\b"),
    "loads": re.compile(r"^LDG\b"),
    "stores": re.compile(r"^STG\b"),
}
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def tool(name):
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", name)


def build(repo, src, out_dir):
    """``nvcc`` of ``repo``'s ``csrc/<src>.cu`` with this checkout's
    package flags and ``-Xptxas -v``; returns (library path, ptxas'
    report)."""
    sys.path.insert(0, ROOT)
    from primme_tpu_torch.ops.build import NVCC_FLAGS

    lib = os.path.join(out_dir, f"lib{src}.so")
    cu = os.path.join(repo, "primme_tpu_torch", "csrc", src + ".cu")
    proc = subprocess.run([tool("nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           lib, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {cu}: {proc.stderr}")
    return lib, proc.stderr


def registers(report):
    """Registers and spill bytes of each function ptxas reports, by its
    mangled name."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
    return out


def sass_counts(lib):
    """Instruction counts by kind of every function of ``lib`` whose
    (demangled) name holds a half type."""
    sass = subprocess.run([tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    names = subprocess.run([tool("cu++filt")], input=sass,
                           capture_output=True, text=True).stdout or sass
    counts, fn = {}, None
    for raw, line in zip(sass.splitlines(), names.splitlines()):
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            mangled = raw.split("Function :", 1)[1].strip()
            keep = "__half" in fn or "bfloat16" in fn
            if keep:
                counts[fn] = {"mangled": mangled, "total": 0,
                              **dict.fromkeys(KINDS, 0)}
            else:
                fn = None
            continue
        m = INSTR.search(line)
        if fn and m:
            op = m.group(1)
            counts[fn]["total"] += 1
            for kind, pat in KINDS.items():
                if pat.search(op) and not (kind == "packed_half"
                                           and op.startswith("HADD2.F32")):
                    counts[fn][kind] += 1
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", action="append",
                    help="a checkout (repeatable; default: this one)")
    ap.add_argument("--json", help="file to write every count to")
    args = ap.parse_args()
    out = collections.OrderedDict()
    with tempfile.TemporaryDirectory() as tmp:
        for repo in args.repo or [ROOT]:
            repo = os.path.abspath(repo)
            for src in SOURCES:
                d = os.path.join(tmp, str(len(out)))
                os.makedirs(d)
                lib, report = build(repo, src, d)
                regs = registers(report)
                rows = sass_counts(lib)
                for fn, c in rows.items():
                    c.update(regs.get(c["mangled"], {}))
                    print(f"[sass] {os.path.relpath(repo, ROOT)} {src}: {fn}: "
                          + " ".join(f"{k}={v}" for k, v in c.items()
                                     if k != "mangled"), flush=True)
                out[f"{repo}:{src}"] = rows
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
