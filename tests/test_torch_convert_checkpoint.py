"""The port's ``tools/convert_checkpoint.py`` against the JAX tool: both
convert the same reference-layout torch file of every checkpoint-surgery
scheme of ``tests/test_convert_checkpoint.py`` (MoCo
``module.encoder_q.``, places ``module.``, the compressed l3 graft, the
Mask R-CNN backbone, CLIP, MAE; full shapes from ``tests/torch_ref``),
and the two files must be the same file to either package: the same
payload keys, ``extra`` and arrays, bit for bit, as written and as each
package's ``load_flat`` reads them back."""

import pickle
import sys

import numpy as np
import pytest
import torch

from pvr_habitat_tpu.models import convert as jconvert
from pvr_habitat_tpu.tools import convert_checkpoint as jtool
from pvr_habitat_tpu_torch.models import convert
from pvr_habitat_tpu_torch.tools import convert_checkpoint as tool
from tests.test_convert_checkpoint import _full_shape_payload

SCHEMES = ["moco_aug", "resnet50_places", "moco_aug_l3", "maskrcnn_l3",
           "clip_vit", "mae_base"]


def _read(path):
    with open(path, "rb") as handle:
        return pickle.load(handle)


@pytest.mark.parametrize("name", SCHEMES)
def test_converted_file_is_the_jax_tools(name, tmp_path, monkeypatch,
                                         capsys):
    payload, _ = _full_shape_payload(name, seed=7)
    src = str(tmp_path / "reference.pth")
    torch.save(payload, src)
    del payload
    outs = {k: str(tmp_path / f"{k}.tar") for k in ("jax", "port")}
    monkeypatch.setattr(sys, "argv", [
        "convert_checkpoint", "--embedding_name", name, "--checkpoint", src,
        "--out", outs["jax"]])
    jtool.main()
    tool.main(["--embedding_name", name, "--checkpoint", src, "--out",
               outs["port"], "--disable_cuda"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[-2].replace(outs["jax"], "OUT") == \
        printed[-1].replace(outs["port"], "OUT"), printed
    assert printed[-1].startswith(f"converted {name}: ")

    want, got = _read(outs["jax"]), _read(outs["port"])
    assert {k: v for k, v in got.items() if k != "params"} == \
        {k: v for k, v in want.items() if k != "params"} == \
        {"format": convert.FLAT_FORMAT, "embedding_name": name}
    assert sorted(got["params"]) == sorted(want["params"])
    for key, value in want["params"].items():
        assert got["params"][key].dtype == value.dtype, key
        np.testing.assert_array_equal(got["params"][key], value,
                                      err_msg=key)

    # read back by each package: the same tensors from either file
    for load in (jconvert.load_flat,
                 lambda path: convert.load_flat(path, "cpu")):
        a, b = load(outs["jax"]), load(outs["port"])
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(b[key]),
                                          np.asarray(a[key]), err_msg=key)


def test_convert_runs_on_the_card_unless_asked(tmp_path):
    """Without CUDA the tool raises unless ``--disable_cuda`` asks for
    the CPU; nothing is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    src = str(tmp_path / "reference.pth")
    torch.save(_full_shape_payload("moco_aug", seed=0)[0], src)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--embedding_name", "moco_aug", "--checkpoint", src,
                   "--out", str(tmp_path / "out.tar")])
    assert not (tmp_path / "out.tar").exists()
