"""Operations and bytes from shapes, and the published peaks they are
held against.

Every count is what the algorithm needs for the call: each input byte
read once, each output byte written once, weights and biases read once,
and the FLOP of the products (2 per multiply-add).  Elementwise work is
left out of the FLOP, so a roofline share or an MFU is never counted
high.  ``block_cost`` and ``attention_cost`` are copies of
``chip_smoke.py``'s, which the benchmark does not import.
"""

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def block_cost(n, h, stride, cin, p, cout, ds, itemsize, flat=False):
    """(bytes, FLOP) of one BN-folded bottleneck block on an (n, h, h,
    cin) input: x read once, the output written once, the weights and
    biases read once; the FLOP of its 1x1, 3x3, 1x1 and shortcut
    products."""
    ho = h // stride
    pix_in = (h + 2) ** 2 if flat else h * h
    pix_out = (ho + 2) ** 2 if flat else ho * ho
    weights = cin * p + 9 * p * p + p * cout + (cin * cout if ds else 0)
    nbytes = (n * (pix_in * cin + pix_out * cout) + weights) * itemsize \
        + 4 * (2 * p + cout * (2 if ds else 1)) + (4 * pix_in if flat else 0)
    flop = 2 * n * (h * h * cin * p + ho * ho * (
        9 * p * p + p * cout + (cin * cout if ds else 0)))
    return nbytes, flop


def attention_cost(n, h, l, d, itemsize):
    """(bytes, FLOP) of one attention core over (n, h, l, d) q, k, v:
    q, k, v read once, the output written once; QK^T and PV."""
    return 4 * n * h * l * d * itemsize, 4 * n * h * l * l * d


def bound_s(nbytes, flop, dtype):
    """The least time the chip could take: the larger of the bytes over
    the memory peak and the FLOP over the dtype's compute peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flop / PEAK_FLOP_PER_S[dtype])


def _conv_macs(hw_out, cin, cout, k):
    return hw_out * hw_out * cin * cout * k * k


def resnet_macs(enc, hw=None):
    """Multiply-adds of one frame through a bottleneck ResNet: the stem,
    every block (``widths`` planes, ``expansion``), the shortcut
    projections; the pooled output has no head."""
    hw = hw or enc["input_hw"]
    side = hw // 2                       # the 7x7/2 stem
    macs = _conv_macs(side, 3, enc["stem_width"], 7)
    side //= 2                           # the 3x3/2 max pool
    cin = enc["stem_width"]
    for stage, (planes, blocks) in enumerate(zip(enc["widths"],
                                                 enc["blocks"])):
        cout = planes * enc["expansion"]
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            out = side // stride
            macs += _conv_macs(side, cin, planes, 1)
            macs += _conv_macs(out, planes, planes, 3)
            macs += _conv_macs(out, planes, cout, 1)
            if i == 0:
                macs += _conv_macs(out, cin, cout, 1)
            side, cin = out, cout
    return macs


def vit_macs(enc, hw=None):
    """Multiply-adds of one frame through a ViT encoder at mask ratio 0:
    the patch embedding, then per block the qkv, QK^T, PV, projection
    and the two MLP products over the L = patches + 1 tokens."""
    hw = hw or enc["input_hw"]
    d, p = enc["embed_dim"], enc["patch"]
    patches = (hw // p) ** 2
    tokens = patches + 1
    mlp = int(d * enc["mlp_ratio"])
    per_block = tokens * (3 * d * d + d * d + 2 * d * mlp) \
        + 2 * tokens * tokens * d
    return patches * 3 * p * p * d + enc["depth"] * per_block


def encoder_flop_per_frame(enc):
    """2 x the multiply-adds of one frame through the configuration's
    encoder."""
    macs = resnet_macs(enc) if enc["arch"] == "resnet" else vit_macs(enc)
    return 2 * macs


def policy_flop_per_frame(pol):
    """Forward FLOP of the BC policy per (t, b) frame: the two ReLU
    linears, every LSTM layer's input and recurrent gate products, and
    the policy and baseline heads."""
    h = pol["hidden_size"]
    macs = pol["obs_size"] * h + h * h
    macs += pol["lstm_layers"] * (h + h) * 4 * h
    macs += h * (pol["num_actions"] + 1)
    return 2 * macs
