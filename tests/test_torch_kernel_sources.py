"""PyTorch port, the CUDA sources of the kernels (K1 and K2 in
``csrc/retrieval.cu``, K4 in ``csrc/attention.cu``, K5 in
``csrc/flash_attention.cu``, their shared Hopper building blocks in
``csrc/*.cuh``):

- the build hash covers the shared headers: editing a header rebuilds every
  library, editing one source only its own;
- the kernel names that ``chip_smoke.py`` reads in the profiler's output
  name kernels of the library each wrapper launches, and of no other
  library, so that no two kernels' device times mix;
- the Hopper building blocks are defined once, in the header.

The kernels themselves compile and run only on a card (``chip_smoke.py``).
"""

import ctypes
import importlib.util
import re
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu_torch.ops import _build  # noqa: E402
from incubator_predictionio_tpu_torch.ops import attention as tatt  # noqa: E402
from incubator_predictionio_tpu_torch.ops import retrieval as tret  # noqa: E402
from incubator_predictionio_tpu_torch.ops import sparse_update as tsu  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ATTENTION = ("attention", "flash_attention")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(name: str) -> list[str]:
    """The ``__global__`` functions defined in csrc/<name>.cu, parsed from
    the source text."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    text = re.sub(r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)", "", text)
    return re.findall(r"__global__\s+void\s+(\w+)\s*\(", text)


def _routes() -> dict[str, str]:
    """Each kernel wrapper's library, as the wrappers launch it: tensors on
    the meta device take the launch path without a card, and a recording
    ``_call`` launches nothing."""
    routes = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(tatt, "_call", lambda what, lib, fn, wrapper, tensors, shape:
               routes.setdefault(wrapper.__name__, lib))
    try:
        q, k, v, do = (torch.empty((1, 1, 128, 64), dtype=torch.bfloat16, device="meta")
                       for _ in range(4))
        st = torch.empty((1, 1, 128), device="meta")
        tatt.causal_mha_small_head(q, k, v)
        tatt.causal_mha_small_head_bwd(q, k, v, do, st, st)
        tatt.flash_causal_attention(q, k, v, 128)
        tatt.flash_causal_attention_bwd(q, k, v, q, do, st, st, 128)
    finally:
        mp.undo()
    return routes


class _Routed(Exception):
    pass


def _retrieval_routes() -> dict[str, str]:
    """K1's and K2's library, as their wrappers launch it: meta tensors with
    the CUDA checks lifted take the launch path, and a recording
    ``_build.library`` stops it there."""
    routes = {}

    def library(name):
        raise _Routed(name)

    mp = pytest.MonkeyPatch()
    mp.setattr(tret, "_check_cuda", lambda what, **tensors: None)
    mp.setattr(_build, "library", library)
    try:
        m = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
            shape, dtype=dtype, device="meta")
        n = tret.ITEM_BLOCK
        for wrapper, args in (
                (tret.score_catalog_quantized,
                 (m(2, 32), m(n, 32, dtype=torch.int8), m(n), m(n), m(n))),
                (tret.score_centroids_quantized,
                 (m(2, 32, dtype=torch.int8), m(2), m(n, 32, dtype=torch.int8),
                  m(n), m(n)))):
            with pytest.raises(_Routed) as routed:
                wrapper(*args)
            routes[wrapper.__name__] = routed.value.args[0]
    finally:
        mp.undo()
    return routes


def _sparse_routes() -> dict[str, str]:
    """K3's two entries' library, as their wrappers launch them (meta
    tensors, the CUDA checks lifted, a recording ``_build.library``)."""
    routes = {}

    def library(name):
        raise _Routed(name)

    mp = pytest.MonkeyPatch()
    mp.setattr(tsu, "_check_cuda", lambda what, **tensors: None)
    mp.setattr(_build, "library", library)
    try:
        m = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
            shape, dtype=dtype, device="meta")
        tabs = (m(16, 33), m(16, 33), m(16, 33))
        for name, call in (
                ("adam_rows", lambda: tsu.adam_rows(m(4, 8, 33), m(2, 8), 0.1)),
                ("adam_rows_indexed", lambda: tsu.adam_rows_indexed(
                    tabs, m(8, dtype=torch.int64), m(8, 33), m(8), m(8),
                    tabs, 0.1))):
            with pytest.raises(_Routed) as routed:
                call()
            routes[name] = routed.value.args[0]
    finally:
        mp.undo()
    return routes


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


def _paths() -> dict[str, Path]:
    return {p.stem: _build.library_path(p.stem) for p in _build.CSRC.glob("*.cu")}


def test_editing_a_header_rebuilds_every_library(csrc_copy):
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert [h.name for h in headers] == ["attention_sm90.cuh"]
    before = _paths()
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = _paths()
    assert sorted(before) == sorted(after) == sorted(p.stem for p in csrc_copy.glob("*.cu"))
    assert all(after[n] != before[n] for n in before)


def test_a_new_header_rebuilds_every_library(csrc_copy):
    before = _paths()
    (csrc_copy / "other.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(after[n] != before[n] for n in before)


@pytest.mark.parametrize("edited", ["attention", "flash_attention", "retrieval",
                                    "sparse_update"])
def test_editing_a_source_rebuilds_only_its_library(csrc_copy, edited):
    before = _paths()
    src = csrc_copy / f"{edited}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert {n for n in before if after[n] != before[n]} == {edited}


def test_unchanged_sources_keep_their_library():
    assert _paths() == _paths()


def test_wrappers_route_to_the_attention_libraries():
    assert _routes() == {
        "causal_mha_small_head": "attention",
        "causal_mha_small_head_bwd": "attention",
        "flash_causal_attention": "flash_attention",
        "flash_causal_attention_bwd_dkv": "flash_attention",
        "flash_causal_attention_bwd_dq": "flash_attention"}


def test_wrappers_route_to_the_retrieval_library():
    assert _retrieval_routes() == {"score_catalog_quantized": "retrieval",
                                   "score_centroids_quantized": "retrieval"}


def test_wrappers_route_to_the_sparse_update_library():
    assert _sparse_routes() == {"adam_rows": "sparse_update",
                                "adam_rows_indexed": "sparse_update"}


def _symbol_cases():
    smoke = _chip_smoke()
    cases = [(w, sym, w) for w, sym in smoke.KERNEL_SYMBOLS.items()]
    cases += [(part, sym, "causal_mha_small_head_bwd")
              for part, sym in smoke.K4_BWD_PART_SYMBOLS.items()]
    cases += [(w, sym, w) for w, sym in smoke.RETRIEVAL_SYMBOLS.items()]
    cases += [(w, sym, w) for w, sym in smoke.SPARSE_SYMBOLS.items()]
    return cases


@pytest.mark.parametrize("name,symbol,wrapper", _symbol_cases())
def test_profiler_symbol_names_a_kernel_of_its_library_only(name, symbol, wrapper):
    lib = {**_routes(), **_retrieval_routes(), **_sparse_routes()}[wrapper]
    assert any(symbol in k for k in _kernels(lib)), (name, symbol, _kernels(lib))
    for other in sorted(p.stem for p in _build.CSRC.glob("*.cu") if p.stem != lib):
        assert not any(symbol in k for k in _kernels(other)), (name, symbol, other)


def test_every_k4_kernel_has_a_symbol():
    """Each K4 kernel is read in the profiler by the forward's symbol or by
    one of the backward's two."""
    smoke = _chip_smoke()
    syms = [smoke.KERNEL_SYMBOLS["causal_mha_small_head"],
            *smoke.K4_BWD_PART_SYMBOLS.values()]
    kernels = _kernels("attention")
    assert len(kernels) == 3
    assert sorted(k for k in kernels if any(s in k for s in syms)) == sorted(kernels)


def test_every_retrieval_kernel_has_a_symbol():
    """Both K1 kernels (the staged one and the one for batches of up to 8)
    are read in the profiler by K1's symbol, K2's kernel by K2's."""
    smoke = _chip_smoke()
    k1, k2 = (smoke.RETRIEVAL_SYMBOLS[w] for w in ("score_catalog_quantized",
                                                   "score_centroids_quantized"))
    kernels = _kernels("retrieval")
    assert len(kernels) == 3
    assert sorted(k for k in kernels if k1 in k) == ["score_catalog_kernel",
                                                     "score_catalog_kernel_b8"]
    assert [k for k in kernels if k2 in k] == ["score_centroids_kernel"]


def test_every_sparse_update_kernel_has_a_symbol():
    """K3's one kernel template (both entries launch it) is read in the
    profiler by K3's symbol."""
    smoke = _chip_smoke()
    assert set(smoke.SPARSE_SYMBOLS.values()) == {"adam_rows_kernel"}
    assert _kernels("sparse_update") == ["adam_rows_kernel"]


_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong}


def _c_parameters(name: str) -> dict[str, list]:
    """Each ``extern "C"`` function of csrc/<name>.cu with the ctypes type
    of each parameter, parsed from the source text."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    block = text.split('extern "C" {', 1)[1].split('}  // extern "C"', 1)[0]
    out = {}
    for fn, params in re.findall(r"\b(pio_\w+)\(([^)]*)\)\s*\{", block):
        types = []
        for p in (x.strip() for x in params.split(",") if x.strip()):
            # a pointer, or the type words before the parameter's name
            types.append(ctypes.c_void_p if "*" in p
                         else _CTYPES[p.rsplit(None, 1)[0]])
        out[fn] = types
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_c_parameters(name):
    """Each argument type in ``_build.SIGNATURES`` is the C parameter's (a
    pointer a ``c_void_p``, an ``int`` a ``c_int``, a ``long long`` a
    ``c_longlong``): a wrong count or width would pass garbage through
    ctypes without an error."""
    params = _c_parameters(name)
    assert sorted(params) == sorted(_build.SIGNATURES[name])
    for fn, (argtypes, _) in _build.SIGNATURES[name].items():
        assert argtypes == params[fn], fn


@pytest.mark.parametrize("block", ["wgmma_ss_n64", "wgmma_rs_n128", "gmma_desc",
                                   "copy_rows", "to_a", "store_rows", "quad_max",
                                   "quad_sum", "dq_rows", "dkv_keys"])
def test_hopper_building_blocks_are_defined_once(block):
    """Defined in the shared header, used (never redefined) by both
    attention sources."""
    define = re.compile(r"__device__ __forceinline__ [\w:<>, ]+?\b" + block + r"\(")
    texts = {p.name: p.read_text() for p in [*_build.CSRC.glob("*.cu"),
                                             *_build.CSRC.glob("*.cuh")]}
    assert [n for n, t in texts.items() if define.search(t)] == ["attention_sm90.cuh"]
    for name in ATTENTION:
        assert '#include "attention_sm90.cuh"' in texts[f"{name}.cu"]


def test_no_wmma_template_is_left():
    for name in ATTENTION:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "nvcuda" not in text and "<mma.h>" not in text
