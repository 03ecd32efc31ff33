#!/usr/bin/env python3
"""What the compiler made of the hand-written CUDA kernels, on a machine
with the CUDA toolkit.

    python3 kernel_report.py

Builds every source in kimera_multi_tpu_torch/kernels/csrc the way the
library does (`kernels/_build.build_all(verbose=True)`, which adds
-Xptxas -v), into a fresh directory, and prints per kernel the registers,
spills and static shared memory ptxas reports and how many of some SASS
instructions `cuobjdump -sass` shows: FFMA / FMUL / FADD for the f32
kernels (K6 is built with FMA contraction, K7 - K9 without), MUFU and FCHK
for a division (FCHK tests for its slow path), FSETP for f32 comparisons,
VOTE for the ballots that compact the valid points of K7 - K9, IGMMA for
the int8 tensor-core products of K1 and K2, POPC / IMNMX / VIMNMX for the
Hamming kernels, LDG / STG / LDS / STS for the loads and stores of the
gathers (K4's two instantiations as `sample_gather_perm_kernel<true>`
(staged) / `<false>`), and the dynamic shared memory of the DB-wide top-2
kernel K2 at 704 queries (`kmt_hamming_top2_smem`, a host function of its
library).
Prints one JSON object {"kernel_report": ...} as its last line.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import re
import subprocess
import sys
import tempfile

SASS_OPS = ("FFMA", "FMUL", "FADD", "MUFU", "FCHK", "FSETP", "VOTE",
            "IGMMA", "IMMA", "POPC", "IMNMX", "VIMNMX", "IMAD", "LOP3", "LDS",
            "STS", "LDGSTS", "LDG", "STG")


def ptxas_info(log: str) -> dict:
    """ptxas -v output -> {mangled kernel: {registers, spill bytes, smem}}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_store_bytes"] = int(m.group(1))
            out[cur]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            if s:
                out[cur]["static_smem_bytes"] = int(s.group(1))
    return out


def sass_counts(cuobjdump: str, lib: str) -> dict:
    """cuobjdump -sass of a library -> {kernel: {opcode: count}}."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = {"instructions": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if cur is None or not m:
            continue
        op = m.group(2).split(".")[0]
        out[cur]["instructions"] += 1
        if op in SASS_OPS:
            out[cur][op] = out[cur].get(op, 0) + 1
    return out


def short(name: str) -> str:
    """A mangled kernel name -> its plain name: the length-prefixed
    identifier that ends in `_kernel` (`..._N_113fivept_kernelE...` ->
    `fivept_kernel`), with a bool template argument where it has one
    (`...20presel_counts_kernelILb1EE...` -> `presel_counts_kernel<true>`)."""
    for m in re.finditer(r"\d+", name):
        for k in range(len(m.group())):
            n = int(m.group()[k:])
            ident = name[m.end():m.end() + n]
            if len(ident) == n and ident.endswith("_kernel"):
                arg = re.match(r"ILb([01])E", name[m.end() + n:])
                if arg:
                    ident += "<true>" if arg.group(1) == "1" else "<false>"
                return ident
    return name


def main() -> None:
    from kimera_multi_tpu_torch.kernels import _build

    try:
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()),
                                 "cuobjdump")
    except RuntimeError as e:
        sys.exit(f"kernel_report: {e}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        _build.BUILD_DIR = tmp
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            paths = _build.build_all(verbose=True)
        info = ptxas_info(log.getvalue())
        report = {}
        for src, lib in paths.items():
            sass = sass_counts(cuobjdump, lib)
            report[src] = {
                "flags": _build.SOURCE_FLAGS[src],
                "kernels": {short(k): {**info.get(k, {}), **v}
                            for k, v in sass.items()}}
        smem = ctypes.CDLL(paths["hamming.cu"]).kmt_hamming_top2_smem
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        report["hamming.cu"]["kernels"]["hamming_top2_kernel"][
            "dynamic_smem_bytes_at_704_queries"] = smem(704)
    for src, entry in report.items():
        for name, k in entry["kernels"].items():
            print(f"{src:11s} {name:28s} {json.dumps(k)}", flush=True)
    for line in log.getvalue().splitlines():
        if "Performance Loss" in line or "warning" in line.lower():
            print(line.strip(), flush=True)
    print(json.dumps({"kernel_report": report}), flush=True)


if __name__ == "__main__":
    main()
