"""W8A8 int8 serving in the port against the JAX package (CPU): the
weight quantization and the quantized params exactly; every conv kind of
the serving path and the linear, whose int32 accumulators agree exactly
from the same int8 input and whose outputs agree within one bf16 ulp
from the same x and scale; ``apply_int8`` of resnet18, resnet50,
resnet50_l3, clip_rn50, maskrcnn_l3 and a small MAE at per-row cosine >
0.9999 with the activation scales equal key by key; the int8 paths
against the port's own f32 path at the JAX package's gates
(``tests/test_quantize.py``); the int8 block's attention core at head
80, where 1/sqrt(head) is not exact in bf16; the registry's dispatch;
and the weight bridge carrying int8 weights.

The JAX side runs un-jitted, as the JAX package's own int8 tests do; it
is computed once per encoder in a module-scoped fixture."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pvr_habitat_tpu.models import clip as jclip
from pvr_habitat_tpu.models import maskrcnn as jmaskrcnn
from pvr_habitat_tpu.models import registry as jregistry
from pvr_habitat_tpu.models import resnet as jresnet
from pvr_habitat_tpu.models import vit as jvit
from pvr_habitat_tpu.ops import image as jimage
from pvr_habitat_tpu.ops import quantize as jq
from pvr_habitat_tpu.ops.fold_bn import fold_resnet_bn as jfold
from pvr_habitat_tpu_torch.models import clip, convert, maskrcnn, registry
from pvr_habitat_tpu_torch.models import resnet, vit
from pvr_habitat_tpu_torch.ops import quantize as q
from pvr_habitat_tpu_torch.ops.cuda import attention as attn

# A small MAE through the full-width code path (the JAX package's own
# int8 MAE test shape): depth 2, width 96, 4 heads, 224 input (L = 197).
SMALL_MAE = dict(depth=2, num_heads=4, patch=16, dim=96)
ENCODERS = ("resnet18", "resnet50", "resnet50_l3", "clip_rn50",
            "maskrcnn_l3", "mae_small")
# cosine gates of the int8 path against f32 (tests/test_quantize.py)
F32_GATE = {"resnet18": 0.99, "resnet50": 0.99, "resnet50_l3": 0.99,
            "clip_rn50": 0.98, "maskrcnn_l3": 0.98, "mae_small": 0.98}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on a few cores: torch's
    and BLAS's thread pools stay small here (the results do not depend
    on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(threads)


def _np(flat):
    return {k: np.asarray(v) for k, v in flat.items()}


def _port(flat):
    return convert.params_from_numpy(_np(flat), "cpu")


def _torch(x):
    """A JAX array -> the same values as a torch tensor of its dtype."""
    dt = torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dt)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


def _row_cos(a, b):
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _small_mae_params(rng, dim=SMALL_MAE["dim"], depth=SMALL_MAE["depth"],
                      patch=SMALL_MAE["patch"]):
    """Xavier-uniform MAE params in the JAX layout (HWIO patch conv)."""
    def xavier(shape):
        a = math.sqrt(6.0 / sum(shape))
        return rng.uniform(-a, a, shape).astype(np.float32)

    ones, zeros = np.ones(dim, np.float32), np.zeros(dim, np.float32)
    p = {"patch_embed.proj.weight": xavier((patch, patch, 3, dim)),
         "patch_embed.proj.bias": rng.randn(dim).astype(np.float32) * 0.1,
         "cls_token": xavier((1, 1, dim)),
         "pos_embed": jvit.sincos_pos_embed_2d(dim, 224 // patch, True)[None],
         "norm.weight": ones, "norm.bias": zeros}
    for i in range(depth):
        pre = f"blocks.{i}"
        p.update({
            f"{pre}.norm1.weight": ones, f"{pre}.norm1.bias": zeros,
            f"{pre}.attn.qkv.weight": xavier((3 * dim, dim)),
            f"{pre}.attn.qkv.bias": rng.randn(3 * dim).astype(np.float32)
            * 0.1,
            f"{pre}.attn.proj.weight": xavier((dim, dim)),
            f"{pre}.attn.proj.bias": zeros,
            f"{pre}.norm2.weight": ones, f"{pre}.norm2.bias": zeros,
            f"{pre}.mlp.fc1.weight": xavier((4 * dim, dim)),
            f"{pre}.mlp.fc1.bias": np.zeros(4 * dim, np.float32),
            f"{pre}.mlp.fc2.weight": xavier((dim, 4 * dim)),
            f"{pre}.mlp.fc2.bias": zeros})
    return p


def _frames(n, seed):
    return jnp.asarray(np.random.RandomState(seed).randint(
        0, 256, (n, 64, 64, 3), np.uint8))


def _encoder(name):
    """(folded params in the JAX layout, the JAX (quantize, apply), the
    port's Int8Serving, the port's f32 apply, the JAX preprocess) of one
    encoder: the JAX package's seeded init, frames preprocessed to 224 as
    the serving path does."""
    if name == "mae_small":
        params = _small_mae_params(np.random.RandomState(9))
        cfg = {k: v for k, v in SMALL_MAE.items() if k != "dim"}
        japply = (jq.quantize_vit_params,
                  lambda p, x, s: jvit.mae_apply_int8(p, x, scales=s, **cfg))
        tserve = registry.Int8Serving(
            q.quantize_vit_params,
            lambda p, x, s, fused="off": vit.mae_apply_int8(
                p, x, scales=s, fused=fused, **cfg), vit.FUSED_ROUTES)
        return (params, japply, tserve,
                lambda p, x: vit.mae_apply(p, x, **cfg),
                jimage.mae_preprocess())
    if name == "clip_rn50":
        params = jclip.init_clip_rn50_params(np.random.RandomState(7))
        f32 = clip.clip_rn50_apply
        pre = jimage.clip_preprocess(224)
    elif name == "maskrcnn_l3":
        params = jmaskrcnn.init_params(np.random.RandomState(7))
        f32 = maskrcnn.apply
        pre = jimage.maskrcnn_preprocess()
    else:
        spec = jregistry._resnet_family(name)[0]
        params = jresnet.init_params(spec, np.random.RandomState(1))
        tspec = registry._resnet_family(name)[0]
        f32 = lambda p, x: resnet.apply(p, x, tspec)  # noqa: E731
        pre = jimage.default_preprocess()
    return (_np(jfold(params)), jregistry.int8_serving_fns(name),
            registry.int8_serving_fns(name), f32, pre)


@pytest.fixture(scope="module")
def jax_int8():
    """name -> the JAX side of one encoder (computed on first use): the
    inputs, the quantized params, the scales calibrated on the batch, and
    the output served with those scales."""
    cache = {}

    def get(name):
        if name not in cache:
            params, (jquant, japply), tserve, f32, pre = _encoder(name)
            frames = _frames(2, seed=3)
            x = pre(frames, out_dtype=jnp.bfloat16)
            params_q = jquant({k: jnp.asarray(v) for k, v in params.items()})
            _, scales = japply(params_q, x, None)
            scales = {k: float(v) for k, v in scales.items()}
            out, _ = japply(params_q, x, scales)
            cache[name] = dict(
                params=params, params_q=_np(params_q), tserve=tserve,
                f32=f32, x=x, x32=pre(frames, out_dtype=jnp.float32),
                scales=scales, out=_f32(out))
        return cache[name]
    return get


# -----------------------------------------------------------------------------
# Weights
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (7, 7, 3, 64), (40, 24)])
def test_quantize_weight_matches_jax(shape):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * 0.1
    w[..., 3] = 0.0                         # an all-zero output channel
    conv = w.ndim == 4
    if not conv:
        w[3] = 0.0
    want_q, want_s = jq.quantize_weight(jnp.asarray(w),
                                        axis=-1 if conv else 0)
    tw = np.transpose(w, (3, 2, 0, 1)) if conv else w   # -> OIHW, (out, in)
    got_q, got_s = q.quantize_weight(torch.from_numpy(
        np.ascontiguousarray(tw)), axis=0)
    want_q = np.asarray(want_q)
    if conv:
        want_q = np.transpose(want_q, (3, 2, 0, 1))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("name", ["resnet50", "clip_rn50", "maskrcnn_l3",
                                  "mae_small"])
def test_quantized_params_match_jax(name, jax_int8):
    """The whole quantized dict, bridged to the port's layout: the same
    keys, the same dtypes (int8 weights, f32 scales), the same values."""
    case = jax_int8(name)
    want = _port(case["params_q"])
    got = case["tserve"].quantize_params(_port(case["params"]))
    assert set(got) == set(want)
    n_int8 = 0
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        torch.testing.assert_close(got[key], value, atol=0, rtol=0)
        n_int8 += value.dtype == torch.int8
        if key.endswith(".wscale"):
            assert value.dtype == torch.float32, key
    assert n_int8 == sum(k.endswith(".wscale") for k in want) > 0


def test_bridge_keeps_int8_weights_and_f32_scales():
    params = {"c.weight": np.random.RandomState(0).randint(
                  -127, 128, (3, 3, 4, 8)).astype(np.int8),
              "c.wscale": np.linspace(0.1, 1, 8).astype(np.float32),
              "c.bias": np.ones(8, np.float32)}
    got = convert.params_from_numpy(params, "cpu", dtype=torch.bfloat16)
    assert got["c.weight"].dtype == torch.int8
    assert got["c.weight"].shape == (8, 4, 3, 3)          # OIHW
    assert got["c.wscale"].dtype == torch.float32
    assert got["c.bias"].dtype == torch.bfloat16
    back = convert.params_to_numpy(got)
    assert back["c.weight"].dtype == np.int8
    np.testing.assert_array_equal(back["c.weight"], params["c.weight"])
    np.testing.assert_array_equal(back["c.wscale"], params["c.wscale"])


# -----------------------------------------------------------------------------
# conv_q and linear_q
# -----------------------------------------------------------------------------

# (name, H, Cin, Cout, kernel, stride, padding): every conv kind of the
# serving path.
CONVS = [
    ("1x1_s1", 14, 64, 32, 1, 1, 0),
    ("1x1_s2", 14, 64, 32, 1, 2, 0),              # projection shortcuts
    ("3x3_s1", 14, 32, 24, 3, 1, 1),
    ("3x3_s2", 14, 32, 24, 3, 2, 1),
    ("stem_7x7_s2_p3", 32, 3, 64, 7, 2, 3),       # K = 147 -> 152
    ("clip_stem_3x3_s2", 32, 3, 32, 3, 2, 1),     # K = 27 -> 32
    ("patch_16x16", 32, 3, 48, 16, 16, 0),        # MAE patch embedding
    ("graft_3x3_cout11", 8, 40, 11, 3, 1, 1),     # compress shortcut, N = 11
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,h,cin,cout,k,stride,pad", CONVS,
                         ids=[c[0] for c in CONVS])
def test_conv_q_matches_jax(name, h, cin, cout, k, stride, pad, dtype):
    rng = np.random.RandomState(len(name))
    x = jnp.asarray(rng.randn(2, h, h, cin).astype(np.float32)).astype(dtype)
    w = rng.randn(k, k, cin, cout).astype(np.float32) * 0.1
    bias = rng.randn(cout).astype(np.float32)
    jp = jq.quantize_resnet_params({"c.weight": jnp.asarray(w)})
    tp = _port(jp)

    # calibration: the same scale
    jqs, tqs = jq.QuantState(), q.QuantState()
    jq.conv_q(jqs, "c", x, jp, stride, pad, bias=jnp.asarray(bias))
    q.conv_q(tqs, "c", _torch(x), tp, stride, pad,
             bias=torch.from_numpy(bias))
    scale = float(jqs.scales["c"])
    assert float(tqs.scales["c"]) == scale

    # the int32 accumulator from the same int8 input, exactly
    x_q = q.quantize_activation(_torch(x), scale)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x_q.numpy()), jp["c.weight"], (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = q.conv_int32(torch.nn.functional.pad(x_q, (0, 0, pad, pad, pad,
                                                     pad)),
                       tp["c.weight"], stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the output from the same x and scale, within one bf16 ulp
    want = _f32(jq.conv_q(jq.QuantState({"c": scale}), "c", x, jp, stride,
                          pad, bias=jnp.asarray(bias)))
    got = q.conv_q(q.QuantState({"c": scale}), "c", _torch(x), tp, stride,
                   pad, bias=torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (np.abs(_f32(got) - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_q_matches_jax(dtype):
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(12, 40).astype(np.float32)).astype(dtype)
    jp = jq.quantize_vit_params({
        "b.mlp.fc.weight": jnp.asarray(rng.randn(20, 40).astype(np.float32)),
        "b.mlp.fc.bias": jnp.asarray(rng.randn(20).astype(np.float32))})
    tp = _port(jp)
    jqs, tqs = jq.QuantState(), q.QuantState()
    jq.linear_q(jqs, "b.mlp.fc", x, jp)
    q.linear_q(tqs, "b.mlp.fc", _torch(x), tp)
    scale = float(jqs.scales["b.mlp.fc"])
    assert float(tqs.scales["b.mlp.fc"]) == scale

    x_q = q.quantize_activation(_torch(x), scale)     # M = 12 pads to 17
    want = jnp.matmul(jnp.asarray(x_q.numpy()), jp["b.mlp.fc.weight"].T,
                      preferred_element_type=jnp.int32)
    got = q.matmul_int32(x_q, tp["b.mlp.fc.weight"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    scales = {"b.mlp.fc": scale}
    want = _f32(jq.linear_q(jq.QuantState(scales), "b.mlp.fc", x, jp))
    got = q.linear_q(q.QuantState(scales), "b.mlp.fc", _torch(x), tp)
    assert (np.abs(_f32(got) - want) <= _bf16_ulp(want)).all()


# -----------------------------------------------------------------------------
# apply_int8 end to end
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ENCODERS)
def test_apply_int8_matches_jax(name, jax_int8):
    """Calibrated on the same batch the scales are equal key by key; served
    with JAX's scales the outputs agree at per-row cosine > 0.9999.  On
    these inputs the largest difference found was 0 for the ResNets and
    maskrcnn_l3, 9.8e-4 for clip_rn50 (outputs up to ~37; the attention
    pool) and 0 for the small MAE."""
    case = jax_int8(name)
    tserve = case["tserve"]
    params_q = _port(case["params_q"])
    x = _torch(case["x"])
    out, scales = tserve.apply(params_q, x, None)
    assert set(scales) == set(case["scales"])
    assert {k: float(v) for k, v in scales.items()} == case["scales"]
    got, served = tserve.apply(params_q, x, case["scales"])
    assert served == case["scales"]
    got = _f32(got)
    assert got.shape == case["out"].shape
    assert np.isfinite(got).all()
    assert _row_cos(got, case["out"]).min() > 0.9999
    # calibrating and serving from the same batch agree
    np.testing.assert_array_equal(_f32(out), got)


@pytest.mark.parametrize("name", ENCODERS)
def test_int8_against_f32_meets_the_jax_gate(name, jax_int8):
    """The port's int8 against its own f32 path, both from the same frames
    (calibrated on them): > 0.99 for the ResNet family, > 0.98 for the
    rest."""
    case = jax_int8(name)
    tserve = case["tserve"]
    params = _port(case["params"])
    want = _f32(case["f32"](params, _torch(case["x32"])))
    got, _ = tserve.apply(tserve.quantize_params(params), _torch(case["x"]),
                          None)
    got = _f32(got)
    assert got.shape == want.shape
    assert _row_cos(got, want).min() > F32_GATE[name]


def test_mae_int8_attention_route(jax_int8, monkeypatch):
    """fused="attention" sends each block's core (bf16, L = 197) to the
    kernel's wrapper with unscaled q (its plain version on the CPU); the
    result stays within the int8 gate of the einsum core."""
    case = jax_int8("mae_small")
    calls = []

    def spy(q_, k_, v_):
        calls.append(q_.shape)
        return attn.fused_attention_ref(q_, k_, v_)
    monkeypatch.setattr(attn, "fused_attention", spy)
    got, _ = case["tserve"].apply(_port(case["params_q"]), _torch(case["x"]),
                                  case["scales"], fused="attention")
    assert calls == [(2, SMALL_MAE["num_heads"], 197,
                      SMALL_MAE["dim"] // SMALL_MAE["num_heads"])] \
        * SMALL_MAE["depth"]
    assert _row_cos(_f32(got), case["out"]).min() > 0.999


def test_int8_block_core_matches_jax_at_head_80(monkeypatch):
    """One int8 block at mae_huge's head width (80; 1/sqrt(80) is not exact
    in bf16): the port's core from JAX's own qkv gives JAX's core output
    (captured at its proj linear) in all but 0.1% of the elements, and
    within two bf16 ulps (the two libraries sum p . v in other orders:
    19 of 63,040 differ here, one by two ulps); scaling q by 1/sqrt(80)
    in f32 instead, as a core that folds the scale would, misses in 6,647
    places."""
    dim, heads = 160, 2
    rng = np.random.RandomState(4)
    p = _small_mae_params(rng, dim=dim, depth=1)
    p = {k: v for k, v in p.items() if k.startswith("blocks.0.")}
    jp = jq.quantize_vit_params({k: jnp.asarray(v) for k, v in p.items()})
    x = jnp.asarray(rng.randn(2, 197, dim).astype(np.float32) * 2) \
        .astype(jnp.bfloat16)
    seen = {}
    linear_q = jq.linear_q

    def spy(qs, name, x_, params, out_dtype=jnp.bfloat16):
        out = linear_q(qs, name, x_, params, out_dtype)
        seen[name] = (x_, out)
        return out
    monkeypatch.setattr(jq, "linear_q", spy)
    jvit._timm_block_q(jq.QuantState(), x, jp, "blocks.0", heads)
    qkv = _torch(seen["blocks.0.attn.qkv"][1]).view(2, 197, 3, heads, 80)
    q_, k_, v_ = (t.transpose(1, 2) for t in qkv.unbind(2))
    want = _f32(seen["blocks.0.attn.proj"][0])
    got = _f32(vit.int8_block_core(q_, k_, v_).transpose(1, 2)
               .reshape(2 * 197, dim))
    misses = (got != want).sum()
    assert misses <= 1e-3 * want.size
    assert (np.abs(got - want) <= 2 * _bf16_ulp(want)).all()
    folded = (q_.float() * (1.0 / math.sqrt(80))).to(torch.bfloat16)
    probs = torch.softmax((folded @ k_.transpose(-1, -2)).float(), -1)
    alt = _f32((probs.to(torch.bfloat16) @ v_).transpose(1, 2)
               .reshape(2 * 197, dim))
    assert (alt != want).sum() > 10 * max(misses, 1)


# -----------------------------------------------------------------------------
# The registry
# -----------------------------------------------------------------------------


def test_int8_serving_fns_dispatch():
    for name in ("resnet18", "resnet34", "resnet50", "resnet50_places",
                 "demy", "moco_aug", "moco_aug_l4", "resnet50_l3",
                 "clip_rn50", "maskrcnn_l3"):
        serve = registry.int8_serving_fns(name)
        assert serve.quantize_params is q.quantize_resnet_params, name
        assert serve.fused_routes == ("off",), name
        with pytest.raises(ValueError, match="no kernel"):
            serve.apply({}, None, None, fused="attention")
    for name in vit.MAE_CONFIGS:
        serve = registry.int8_serving_fns(name)
        assert serve.quantize_params is q.quantize_vit_params
        assert serve.fused_routes == ("off", "attention")
    for name in ("moco_aug_uber_345", "moco_croponly_places_uber_34"):
        with pytest.raises(NotImplementedError, match="uber"):
            registry.int8_serving_fns(name)
    for name in ("random", "clip_vit", "true_state"):
        with pytest.raises(NotImplementedError):
            registry.int8_serving_fns(name)
