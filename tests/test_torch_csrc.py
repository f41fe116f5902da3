"""The port's CUDA sources (``ponderv2_tpu_torch/csrc``) read as text, on the
CPU: nothing here compiles them (``tests/test_torch_cuda.py`` runs the
kernels on a GPU).

- Every C entry point that a wrapper binds takes the pointers and ints its
  ``_CudaKernel`` declares, in that order, then the stream: ctypes passes
  what ``argtypes`` says, so a mismatch would pass wrong values, not fail.
- Every quoted ``#include`` names a header of ``csrc``; the headers are the
  band plan's row functor and the tensor-core tiles (the CUDA-core GEMM
  tile is gone).
- Every text edit of ``tools/experiments/probe_mma_variants_torch.py``
  still finds its target, so that its tile variants build from the
  current sources.
"""

import os
import re
import sys

import pytest

from ponderv2_tpu_torch.ops import band_conv as bc
from ponderv2_tpu_torch.ops import probe_kernels as pk
from ponderv2_tpu_torch.ops import row_gather as rg
from ponderv2_tpu_torch.ops import windowed_gather as wg
from ponderv2_tpu_torch.ops.cuda_build import CSRC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools", "experiments"))
import probe_mma_variants_torch as variants  # noqa: E402

KERNELS = bc.KERNELS + wg.KERNELS + wg.PROBE_KERNELS + rg.KERNELS + pk.KERNELS
ENTRIES = [(k, dtype) for k in KERNELS for dtype in (k.dtypes or (None,))]


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _c_params(source, entry):
    """'p' (a pointer) or 'i' (an int) per parameter of ``int entry(...)`` in
    the extern "C" block of ``csrc/<source>.cu``."""
    text = _read(f"{source}.cu")
    body = text[text.index('extern "C" {'):]
    m = re.search(r"\bint\s+" + entry + r"\(([^)]*)\)\s*\{", body)
    assert m, f"{entry} not found in csrc/{source}.cu"
    kinds = []
    for param in m[1].split(","):
        param = " ".join(param.split())
        kinds.append("p" if "*" in param else "i" if param.startswith("int ") else param)
    return kinds


@pytest.mark.parametrize("kernel,dtype", ENTRIES,
                         ids=[k._entry(d) for k, d in ENTRIES])
def test_c_entry_point_takes_the_wrappers_arguments(kernel, dtype):
    kinds = ["p" if t.__name__ == "c_void_p" else "i" for t in kernel.argtypes]
    assert kinds[-1] == "p"  # the stream
    assert _c_params(kernel.source, kernel._entry(dtype)) == kinds


def test_sources_include_only_their_own_headers():
    sources = sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    headers = {f for f in sources if f.endswith(".cuh")}
    assert headers == {"band_rows.cuh", "mma_tile.cuh"}
    for name in sources:
        for inc in re.findall(r'^#include "([^"]+)"', _read(name), re.M):
            assert inc in headers, f"{name} includes {inc}"
    assert set(variants.HEADERS) == headers


def _variant_edits():
    """(tool, variant, edits) of every tile variant."""
    out = [(tool, name, edits) for tool, table in (("k1", variants.K1), ("k2", variants.K2),
                                                   ("k4", variants.K4), ("v5", variants.V5),
                                                   ("p1", variants.GATHER), ("k0", variants.COPY),
                                                   ("ka", variants.SLOTS),
                                                   ("kb", variants.CONCAT),
                                                   ("kc2", variants.SUM_ROWS))
           for name, edits in table.items()]
    own = next(ln for ln in _read("probe_kernels.cu").splitlines()
               if ln.startswith(variants.KD_LINE))
    for name, (params, edits) in variants.KD.items():
        tile = [("probe_kernels.cu", own, variants.KD_LINE + params)] if params else []
        out.append(("kd", name, tile + edits))
    return out


@pytest.mark.parametrize("tool,name,edits", _variant_edits(),
                         ids=[f"{t}-{n}" for t, n, _ in _variant_edits()])
def test_variant_edits_find_their_targets(tool, name, edits):
    """Each edit applies to the source as ``probe_mma_variants_torch.build``
    applies them: in order, each to the text the edits before it left."""
    texts = {}
    for target, old, new in edits:
        texts.setdefault(target, _read(target))
        assert old in texts[target], f"{tool} {name}: {old!r} not in {target}"
        texts[target] = texts[target].replace(old, new)
