"""The inputs of every run, made from ``--seed`` on the device: encoder
and policy weights, the frame pool, the BC dataset.

Each draws from its own stream, ``generator(seed, tag)``, in a few
large calls (one normal and one uniform buffer per weight set, sliced
into the leaves), in float32, the type the weights are handed over in.
The same seed gives the same inputs; the sizes never depend on it.
"""

import hashlib
import math

import numpy as np
import torch


def subseed(seed, tag):
    """A 63-bit seed of the stream ``tag`` of run seed ``seed`` (any
    whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed, tag, device):
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, tag))
    return g


class _Draws:
    """Leaves as views of one normal and one uniform [0, 1) buffer."""

    def __init__(self, specs, g, device):
        total = sum(math.prod(shape) for _, shape, _ in specs)
        self.normal = torch.randn(total, generator=g, device=device)
        self.uniform = torch.rand(total, generator=g, device=device)
        self.offset = 0

    def take(self, shape, uniform=False):
        size = math.prod(shape)
        buf = self.uniform if uniform else self.normal
        out = buf[self.offset:self.offset + size].view(shape)
        self.offset += size
        return out


def _bn_specs(prefix, ch, branch_end=False):
    return [(f"{prefix}.weight", (ch,), "bn_scale_end" if branch_end
             else "scale"),
            (f"{prefix}.bias", (ch,), "shift"),
            (f"{prefix}.running_mean", (ch,), "bn_mean"),
            (f"{prefix}.running_var", (ch,), "bn_var")]


def resnet_specs(enc):
    specs = [("conv1.weight", (enc["stem_width"], 3, 7, 7), "he")]
    specs += _bn_specs("bn1", enc["stem_width"])
    cin = enc["stem_width"]
    for stage, (planes, blocks) in enumerate(zip(enc["widths"],
                                                 enc["blocks"])):
        cout = planes * enc["expansion"]
        for i in range(blocks):
            p = f"layer{stage + 1}.{i}"
            specs += [(f"{p}.conv1.weight", (planes, cin, 1, 1), "he")]
            specs += _bn_specs(f"{p}.bn1", planes)
            specs += [(f"{p}.conv2.weight", (planes, planes, 3, 3), "he")]
            specs += _bn_specs(f"{p}.bn2", planes)
            specs += [(f"{p}.conv3.weight", (cout, planes, 1, 1), "he")]
            specs += _bn_specs(f"{p}.bn3", cout, branch_end=True)
            if i == 0:
                specs += [(f"{p}.downsample.0.weight", (cout, cin, 1, 1),
                           "he")]
                specs += _bn_specs(f"{p}.downsample.1", cout)
            cin = cout
    return specs


def vit_specs(enc):
    d, p = enc["embed_dim"], enc["patch"]
    mlp = int(d * enc["mlp_ratio"])
    specs = [("patch_embed.proj.weight", (d, 3, p, p), "xavier"),
             ("patch_embed.proj.bias", (d,), "bias"),
             ("cls_token", (1, 1, d), "bias")]
    for i in range(enc["depth"]):
        b = f"blocks.{i}"
        specs += [(f"{b}.norm1.weight", (d,), "scale"),
                  (f"{b}.norm1.bias", (d,), "shift"),
                  (f"{b}.attn.qkv.weight", (3 * d, d), "xavier"),
                  (f"{b}.attn.qkv.bias", (3 * d,), "bias"),
                  (f"{b}.attn.proj.weight", (d, d), "xavier"),
                  (f"{b}.attn.proj.bias", (d,), "bias"),
                  (f"{b}.norm2.weight", (d,), "scale"),
                  (f"{b}.norm2.bias", (d,), "shift"),
                  (f"{b}.mlp.fc1.weight", (mlp, d), "xavier"),
                  (f"{b}.mlp.fc1.bias", (mlp,), "bias"),
                  (f"{b}.mlp.fc2.weight", (d, mlp), "xavier"),
                  (f"{b}.mlp.fc2.bias", (d,), "bias")]
    specs += [("norm.weight", (d,), "scale"),
              ("norm.bias", (d,), "shift")]
    return specs


def policy_specs(pol):
    h, o, a = pol["hidden_size"], pol["obs_size"], pol["num_actions"]
    specs = [("fc.0.weight", (h, o), "relu_normal"), ("fc.0.bias", (h,),
                                                      "zero"),
             ("fc.2.weight", (h, h), "relu_normal"), ("fc.2.bias", (h,),
                                                      "zero")]
    for layer in range(pol["lstm_layers"]):
        specs += [(f"core.weight_ih_l{layer}", (4 * h, h), "lstm"),
                  (f"core.weight_hh_l{layer}", (4 * h, h), "lstm"),
                  (f"core.bias_ih_l{layer}", (4 * h,), "lstm"),
                  (f"core.bias_hh_l{layer}", (4 * h,), "lstm")]
    specs += [("policy.weight", (a, h), "head_normal"),
              ("policy.bias", (a,), "zero"),
              ("baseline.weight", (1, h), "head_normal"),
              ("baseline.bias", (1,), "zero")]
    return specs


def _leaf(draws, shape, kind, hidden=None):
    if kind == "he":                   # He normal, fan_out (torchvision)
        fan_out = shape[0] * math.prod(shape[2:])
        return draws.take(shape) * math.sqrt(2.0 / fan_out)
    if kind == "xavier":
        fan_out, fan_in = shape[0], math.prod(shape[1:])
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return (draws.take(shape, uniform=True) * 2 - 1) * a
    if kind == "relu_normal":
        return draws.take(shape) * math.sqrt(2.0 / shape[1])
    if kind == "head_normal":
        return draws.take(shape) * math.sqrt(1.0 / shape[1])
    if kind == "lstm":
        k = 1.0 / math.sqrt(hidden)
        return (draws.take(shape, uniform=True) * 2 - 1) * k
    if kind == "scale":                # BatchNorm and LayerNorm gains
        return 1.0 + 0.05 * draws.take(shape)
    if kind == "bn_scale_end":         # the branch's last BN: 0.1 - 0.3
        return 0.1 + 0.2 * draws.take(shape, uniform=True)
    if kind in ("shift", "bn_mean"):
        return 0.05 * draws.take(shape)
    if kind == "bn_var":
        return 0.75 + 0.5 * draws.take(shape, uniform=True)
    if kind == "bias":
        return 0.02 * draws.take(shape)
    if kind == "zero":
        draws.take(shape)
        return torch.zeros(shape, device=draws.normal.device)
    raise ValueError(f"unknown init {kind!r}")


def _weights(specs, g, device, hidden=None):
    draws = _Draws(specs, g, device)
    return {key: _leaf(draws, shape, kind, hidden).contiguous()
            for key, shape, kind in specs}


def sincos_pos_embed(dim, grid):
    """MAE's fixed 2-D sin-cos position embedding with a zero CLS row,
    (1, grid * grid + 1, dim) float32 (arXiv:2111.06377, the MAE code's
    get_2d_sincos_pos_embed)."""
    def one_axis(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64)
                                / (d / 2.0))
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gw, gh = np.meshgrid(np.arange(grid, dtype=np.float32),
                         np.arange(grid, dtype=np.float32))
    emb = np.concatenate([one_axis(dim // 2, gw), one_axis(dim // 2, gh)],
                         axis=1)
    emb = np.concatenate([np.zeros((1, dim)), emb], axis=0)
    return torch.from_numpy(emb.astype(np.float32))[None]


def encoder_weights(enc, seed, device):
    """The configuration's encoder weights, keyed as torch module paths
    (the key layout of the published checkpoints), float32."""
    g = generator(seed, "encoder", device)
    if enc["arch"] == "resnet":
        return _weights(resnet_specs(enc), g, device)
    w = _weights(vit_specs(enc), g, device)
    w["pos_embed"] = sincos_pos_embed(
        enc["embed_dim"], enc["input_hw"] // enc["patch"]).to(device)
    return w


def policy_weights(pol, seed, device):
    return _weights(policy_specs(pol), generator(seed, "policy", device),
                    device, hidden=pol["hidden_size"])


def frame_pool(n, hw, seed, device):
    """(n, hw, hw, 3) uint8 frames in host memory, drawn on the device."""
    g = generator(seed, "frames", device)
    return torch.randint(0, 256, (n, hw, hw, 3), generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()


def trajectory_lengths(traffic, seed):
    """The same multiset of lengths for every seed, spread evenly over
    [min_length, max_length], in an order drawn from the seed."""
    n, lo, hi = (traffic["trajectories"], traffic["min_length"],
                 traffic["max_length"])
    lengths = lo + (np.arange(n) * (hi - lo)) // max(n - 1, 1)
    order = np.random.default_rng(subseed(seed, "lengths")).permutation(n)
    return lengths[order]


def bc_dataset(traffic, obs_size, num_actions, seed, device):
    """One scene's embedded BC dataset on the device: obs (N, obs_size)
    float32 in [0, 1), expert actions (N,) int64, done (N,) bool, True
    at the last step of each trajectory."""
    lengths = trajectory_lengths(traffic, seed)
    n = int(lengths.sum())
    g = generator(seed, "dataset", device)
    obs = torch.rand((n, obs_size), generator=g, device=device)
    action = torch.randint(0, num_actions, (n,), generator=g, device=device)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    done[torch.as_tensor(np.cumsum(lengths) - 1, device=device)] = True
    return dict(obs=obs, action=action, done=done)
