"""The kernel build's bookkeeping, which runs without nvcc: where a build
lives, and the ptxas report that ``chip_smoke.py`` and
``tools/attention_tilings.py`` and ``tools/bottleneck_variants.py``
print."""

import pytest
import torch

from pvr_habitat_tpu_torch.ops.cuda import build
from pvr_habitat_tpu_torch.tools import bottleneck_variants

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


def test_variant_timing_tool_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bottleneck_variants.main([]) == 1
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
