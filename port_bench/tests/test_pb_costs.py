"""``costs.py`` from shapes: the published counts and its own pieces."""

import pytest

from port_bench import costs, harness

RESNET = harness.load("configs", "pvr_resnet50")
MAE = harness.load("configs", "pvr_mae_base")


def test_resnet50_macs():
    assert costs.resnet_macs(RESNET["encoder"]) / 1e9 == pytest.approx(
        4.09, abs=0.02)


def test_vit_b16_macs():
    assert costs.vit_macs(MAE["encoder"]) / 1e9 == pytest.approx(
        17.56, abs=0.05)


def test_blocks_add_up_to_the_trunk():
    """The blocks' FLOP (``block_cost``, as the roofline counts them) and
    the stem's make the whole ResNet-50's."""
    enc = RESNET["encoder"]
    side, cin, flop = 56, 64, 0
    for stage, (planes, blocks) in enumerate(zip(enc["widths"],
                                                 enc["blocks"])):
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            flop += costs.block_cost(1, side, stride, cin, planes, planes * 4,
                                     i == 0, 2)[1]
            side, cin = side // stride, planes * 4
    stem = 2 * 112 * 112 * 3 * 64 * 49
    assert flop + stem == 2 * costs.resnet_macs(enc)


def test_policy_flop():
    assert costs.policy_flop_per_frame(RESNET["policy"]) == 2 * (
        2048 * 1024 + 1024 * 1024 + 2 * 2048 * 4096 + 1024 * 4)


def test_bound_takes_the_larger():
    assert costs.bound_s(3.35e12, 0, "bfloat16") == pytest.approx(1.0)
    assert costs.bound_s(0, 67e12, "float32") == pytest.approx(1.0)
