#!/usr/bin/env python3
"""Compare the machine code of the port's CUDA sources in two checkouts,
kernel by kernel: whether an edit to a shared header (``csrc/*.cuh``)
changes the code of the kernels that did not ask for it.

    python tools/experiments/sass_diff_torch.py OTHER_ROOT [source ...]

Builds ``ponderv2_tpu_torch/csrc/<source>.cu`` (default: ``band_conv`` and
``band_conv_bwd``, K1-K3) of this checkout and of ``OTHER_ROOT`` (another
checkout, such as the parent commit unpacked with ``git archive``) with the
package's nvcc flags, in parallel, into a temporary directory; disassembles
both with ``cuobjdump -sass`` and prints, per kernel, ``same`` or ``DIFF``
with the instruction count of each build. Kernel names are compared without
the anonymous namespace's per-file hash. A kernel whose name is in one build
only (a template that gained or changed a parameter) is matched by its
instructions to one of the other build's unmatched kernels, and printed
``same`` with both names. Needs the CUDA toolkit, not a GPU. Exits 1 if a
kernel differs or is missing from one build.
"""

import hashlib
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from ponderv2_tpu_torch.ops.cuda_build import NVCC_FLAGS, _nvcc  # noqa: E402


def kernels(lib):
    """{kernel name: (md5 of its instructions, instruction count)}."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        code = [line.split("*/", 1)[1].strip() for line in body.splitlines()
                if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
        name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "(anon)", name)
        out[name] = (hashlib.md5("\n".join(code).encode()).hexdigest(), len(code))
    return out


def match_renamed(this, that):
    """{name here: name in the other build} for kernels whose names are in
    one build only, paired by equal instructions."""
    by_code = {}
    for name in sorted(set(that) - set(this)):
        by_code.setdefault(that[name], []).append(name)
    return {name: by_code[this[name]].pop(0) for name in sorted(set(this) - set(that))
            if by_code.get(this[name])}


def main(argv) -> int:
    if not argv:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    other, sources = os.path.abspath(argv[0]), argv[1:] or ["band_conv", "band_conv_bwd"]
    trees = {"this": ROOT, "other": other}
    differ = 0
    with tempfile.TemporaryDirectory(prefix="sass_diff_") as tmp:
        procs = {}
        for tree, root in trees.items():
            for src in sources:
                lib = os.path.join(tmp, f"{tree}_{src}.so")
                cu = os.path.join(root, "ponderv2_tpu_torch", "csrc", f"{src}.cu")
                procs[tree, src] = (lib, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", lib, cu], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        for (tree, src), (_, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                print(f"{tree} {src}: build failed\n{log[-2000:]}")
                return 1
        for src in sources:
            this, that = (kernels(procs[t, src][0]) for t in trees)
            print(f"== {src}: {len(this)} kernels here, {len(that)} in {other}")
            renamed = match_renamed(this, that)
            for name in sorted(set(this) | set(that)):
                if name in renamed.values():
                    continue  # printed beside its new name
                a, b = this.get(name), that.get(name)
                was = ""
                if name in renamed:
                    b, was = that[renamed[name]], f" (other: {renamed[name]})"
                same = a is not None and a == b
                differ += not same
                print(f"{'same' if same else 'DIFF'} {name}{was}: here "
                      f"{a[1] if a else 'missing'}, other {b[1] if b else 'missing'} instructions")
    print(f"{differ} kernel(s) differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
