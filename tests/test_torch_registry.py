"""Every name of the JAX package's zoo builds in the port with the JAX
package's output size (the port's counterpart of
``tests/test_registry.py::test_encoder_constructible_with_expected_dim``,
which leaves out the big mae_large and mae_huge inits the same way;
``tests/test_torch_vit.py`` covers their configs), and the bulk embedder
embeds with each encoder this slice added."""

import numpy as np
import pytest
import torch

from pvr_habitat_tpu_torch.data import formats
from pvr_habitat_tpu_torch.models import registry
from pvr_habitat_tpu_torch.tools import (save_embedded_obs,
                                         save_opt_trajectories)
from tests.test_registry import _expected

ENV = "FakePointNav-apartment_0"


@pytest.mark.parametrize("name", [
    n for n in registry.all_encoder_names()
    if n not in ("mae_large", "mae_huge")])
def test_encoder_builds_with_the_jax_out_size(name):
    handle = registry.build_encoder(name, pretrained=False, device="cpu")
    assert handle.out_size == _expected(name), name
    if name != "true_state":
        assert handle.preprocess is not None
        assert handle.params and all(
            isinstance(v, torch.Tensor) and v.dtype == torch.float32
            for v in handle.params.values())
    if "_uber_" in name:
        assert handle.sub_names == registry.uber_constituents(name)
        assert handle.fused_routes == ("off", "v1")
        assert all(k.split(".")[1] in ("0", "1", "2")
                   and k.startswith("models.") for k in handle.params)


def test_uber_dims_match_the_survey_and_concatenate():
    """The four fusion codes' dims (the parametrized test above holds each
    uber's out_size to these), and one forward's concatenation: at a 64x64
    input the l4 graft's map is 42 x 2 x 2."""
    for name, dim in (("moco_aug_uber_345", 6262), ("moco_aug_uber_34", 4214),
                      ("moco_aug_uber_35", 4204), ("moco_aug_uber_45", 4106)):
        assert _expected(name) == dim
    handle = registry.build_encoder("moco_aug_uber_45", pretrained=False,
                                    device="cpu")
    sub = registry.build_encoder("moco_aug_l4", pretrained=False,
                                 device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 64, 64, 3)
                         .astype(np.float32))
    out = handle.apply_fn(handle.params, x)
    assert out.shape == (1, 42 * 2 * 2 + 2048)
    torch.testing.assert_close(out[:, :168], sub.apply_fn(sub.params, x),
                               atol=0, rtol=0)


@pytest.fixture(scope="module")
def raw_data(tmp_path_factory):
    """One raw FakePointNav trajectory (the port's datagen)."""
    path = tmp_path_factory.mktemp("embed")
    flags = save_opt_trajectories.build_tool_parser().parse_args(
        ["--env", ENV, "--save_path", str(path), "--n_trajectories", "1",
         "--max_episode_steps", "40"])
    save_opt_trajectories.gen_data_habitat(flags)
    return path


@pytest.mark.parametrize("name,dim", [
    ("clip_vit", 512), ("clip_rn50", 1024), ("maskrcnn_l3", 2156),
    ("moco_aug_uber_345", 6262)])
def test_bulk_embedder_embeds_with_the_zoo(raw_data, name, dim):
    """The pickle source of ``save_embedded_obs`` reaches every new
    encoder through the registry."""
    flags = save_embedded_obs.build_tool_parser().parse_args(
        ["--env", ENV, "--data_path", str(raw_data), "--embedding_name",
         name, "--source", "pickle", "--disable_pretrained_embedding",
         "--disable_cuda"])
    data = formats.load_pickle(save_embedded_obs.run(flags))
    n = len(data["action"])
    assert n > 0 and data["obs"].shape == (n, dim)
    assert np.isfinite(data["obs"]).all()
