"""Build flags of the port's CUDA sources (kernels/_build.py), on the CPU:
no nvcc is run. The scoring, gather and Hamming libraries are built
without FMA contraction, so their integer decisions equal the plain
versions'; the five-point library contracts; a library's file name
changes with its flags, so a changed flag never loads a stale build."""

import pytest

from kimera_multi_tpu_torch.kernels import _build


@pytest.mark.parametrize("src", ["score.cu", "gather.cu", "hamming.cu"])
def test_exact_sources_do_not_contract(src):
    flags = _build.nvcc_flags(src)
    assert "-fmad=false" in flags and "-fmad=true" not in flags


def test_fivept_contracts_with_ieee_division():
    flags = _build.nvcc_flags("fivept.cu")
    assert "-fmad=false" not in flags
    for fast in ("-use_fast_math", "--use_fast_math", "-ftz=true",
                 "-prec-div=false", "-prec-sqrt=false"):
        assert fast not in flags


def test_every_source_has_flags():
    assert set(_build.SOURCE_FLAGS) == set(_build.SOURCES)


def test_lib_path_follows_the_flags(monkeypatch):
    before = {src: _build._lib_path(src) for src in _build.SOURCES}
    monkeypatch.setitem(_build.SOURCE_FLAGS, "fivept.cu", ["-fmad=false"])
    after = {src: _build._lib_path(src) for src in _build.SOURCES}
    assert after["fivept.cu"] != before["fivept.cu"]
    assert all(after[s] == before[s] for s in before if s != "fivept.cu")
