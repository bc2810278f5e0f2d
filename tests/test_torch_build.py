"""The kernel build's bookkeeping, which runs without nvcc: where a build
lives, and the ptxas report that ``chip_smoke.py`` and
``tools/attention_tilings.py`` and ``tools/bottleneck_variants.py``
print."""

import ctypes
import re

import pytest
import torch

from pvr_habitat_tpu_torch.ops.cuda import build
from pvr_habitat_tpu_torch.tools import (bottleneck_launch_shapes,
                                         bottleneck_variants)

# ``nvcc -Xptxas -v`` output for two instances of the attention source.
PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120attention_mma_kernelILi4ELi13EEEvNS_4ArgsI13__nv_bfloat16EE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120attention_mma_kernelILi4ELi13EEEvNS_4ArgsI13__nv_bfloat16EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 920 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120attention_mma_kernelILi5ELi13EEEvNS_4ArgsI13__nv_bfloat16EE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120attention_mma_kernelILi5ELi13EEEvNS_4ArgsI13__nv_bfloat16EE
    16 bytes stack frame, 12 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, 920 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120attention_f32_kernelENS_4ArgsIfEE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120attention_f32_kernelENS_4ArgsIfEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 920 bytes cmem[0]
"""


def test_ptxas_report_names_each_instance():
    assert build.ptxas_report(PTXAS) == [
        ("attention_mma_kernel<4,13>", 168, 0, 0),
        ("attention_mma_kernel<5,13>", 168, 12, 24),
        ("attention_f32_kernel", 40, 0, 0),
    ]


def test_short_name_keeps_integer_and_bool_arguments():
    assert (build._short_name("_Z20fused_bottleneck_kerILi4ELb1EEvv")
            == "fused_bottleneck_ker<4,1>")
    assert build._short_name("plain_c_name") == "plain_c_name"
    # the bf16 bottleneck kernel's v1 and v2 instances
    for flat in (0, 1):
        mangled = (f"_ZN12_GLOBAL__N_121bottleneck_mma_kernelILb{flat}EEEv"
                   "NS_4ArgsI13__nv_bfloat16EE")
        assert build._short_name(mangled) == f"bottleneck_mma_kernel<{flat}>"
    # the f32 engine's instances keep the engine's name
    for flat in (0, 1):
        mangled = (f"_ZN12_GLOBAL__N_117bottleneck_kernelINS_12ScalarEngine"
                   f"ELb{flat}EEEvNS_4ArgsINT_1TEEE")
        assert (build._short_name(mangled)
                == f"bottleneck_kernel<ScalarEngine,{flat}>")
    assert (build._short_name("_Z3fooI12ScalarEngineLi2EEvv")
            == "foo<ScalarEngine,2>")


# C types of the launchers' parameters and results -> ctypes
_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong, "const char*": ctypes.c_char_p,
            "const long long*": ctypes.POINTER(ctypes.c_longlong)}


def _c_type(decl, named=True):
    """The ctypes type of a C parameter such as ``const void* x`` (or,
    not ``named``, of a result type such as ``long long``)."""
    decl = decl.strip()
    if named:
        decl = re.sub(r"\s*\w+$", "", decl)
    decl = re.sub(r"\s+\*", "*", decl)
    return _C_TYPES.get(decl, ctypes.c_void_p if decl.endswith("*")
                        else None)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signatures_match_the_c_interface(name):
    """Every function of each source's ``extern "C"`` block has the
    argtypes and restype that ``build.SIGNATURES`` gives ctypes: a
    launcher whose C parameters moved would read its arguments shifted."""
    text = (build.CSRC / f"{name}.cu").read_text()
    text = text[text.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"^([\w ]+\*?)\s+(\w+)\(([^)]*)\)\s*\{", text,
                         re.M):
        params = [p for p in m.group(3).split(",") if p.strip()]
        found[m.group(2)] = ([_c_type(p) for p in params],
                             _c_type(m.group(1), named=False))
    assert found == build.SIGNATURES[name]


def test_variant_timing_tool_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bottleneck_variants.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_launch_shape_timing_tool_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bottleneck_launch_shapes.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_library_path_follows_source(tmp_path):
    default = build.library_path("fused_attention")
    assert default == build.library_path("fused_attention", None)
    assert default == build.library_path("fused_attention",
                                         build.CSRC / "fused_attention.cu")
    other = tmp_path / "fused_attention.cu"
    other.write_text("// another version\n")
    moved = build.library_path("fused_attention", other)
    assert moved != default and moved.parent == default.parent
    assert all(p.name.startswith("fused_attention-")
               for p in (default, moved))


def test_ptxas_output_is_read_from_beside_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    source = tmp_path / "fused_attention.cu"
    source.write_text("// another version\n")
    assert build.ptxas_output("fused_attention", source) == ""
    log = build.library_path("fused_attention", source).with_suffix(".ptxas")
    assert log.parent == tmp_path
    log.write_text(PTXAS)
    assert build.ptxas_output("fused_attention", source) == PTXAS
    assert build.ptxas_output("fused_attention") == ""
