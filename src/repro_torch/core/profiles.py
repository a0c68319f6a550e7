"""DNN execution profiles: per-layer FLOPs / activation bytes / params
(port of ``repro.core.profiles``; plain Python).

The paper profiles VGG{11,19}, ResNet{18,50}, DenseNet{121,161} on a Jetson
TX2 and picks 4 candidate cut points per version (Table I). This container
has no Jetson, so profiles are derived *analytically* from the architectures
(224x224x3 ImageNet input, op-level enumeration mirroring torchvision's
features+classifier indexing so Table I indices land on meaningful ops).
Accuracies are the published ImageNet top-1 numbers.

The same ``ModelProfile`` abstraction also wraps the transformer
architectures (built from ModelConfig) so the EdgeRL controller can pick
(version, cut) for them too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

BYTES_PER_ELT = 4  # fp32 activations on-device (TX2 regime)


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    name: str
    flops: float          # FLOPs to execute this op (per frame)
    out_bytes: float      # activation bytes leaving this op
    params: int
    weight_bytes: float = 0.0   # actual weight bytes of this op under the
                                # owning version (0 -> derive from params)


@dataclasses.dataclass(frozen=True)
class VersionProfile:
    model: str
    version: str
    accuracy: float                   # top-1, [0,1]
    layers: Tuple[LayerProfile, ...]
    cut_points: Tuple[int, ...]       # candidate cut layer indices (Table I)
    bytes_per_param: float = 4.0      # weight-shipping cost (quant versions <4)

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def total_flops(self) -> float:
        return float(sum(l.flops for l in self.layers))

    def head_flops(self, cut: int) -> float:
        return float(sum(l.flops for l in self.layers[:cut]))

    def tail_flops(self, cut: int) -> float:
        return float(sum(l.flops for l in self.layers[cut:]))

    def cut_bytes(self, cut: int) -> float:
        if cut <= 0:
            # full offload: ship the input frame
            return 224 * 224 * 3 * BYTES_PER_ELT
        if cut >= len(self.layers):
            return 16.0   # just the class id
        return self.layers[cut - 1].out_bytes

    def tail_weight_bytes(self, cut: int) -> float:
        """Bytes to place this version's tail on the server — the
        weight-shipping side of a (version, cut) switch. Uses per-layer
        measured weight_bytes when the profile provides them (quantized
        transformer versions price only the dense share at the reduced
        width); otherwise params x bytes_per_param (CNN paper profiles)."""
        tail = self.layers[cut:]
        wb = float(sum(l.weight_bytes for l in tail))
        if wb > 0:
            return wb
        return float(sum(l.params for l in tail)) * self.bytes_per_param


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    versions: Tuple[VersionProfile, ...]


# --------------------------------------------------------------------------
# CNN shape inference (conv / pool / fc ops)
# --------------------------------------------------------------------------

def _conv(name, cin, cout, k, s, hw, p=None):
    """Returns (layer, new_hw)."""
    pad = k // 2 if p is None else p
    out = (hw + 2 * pad - k) // s + 1
    flops = 2.0 * k * k * cin * cout * out * out
    return LayerProfile(name, flops, cout * out * out * BYTES_PER_ELT,
                        k * k * cin * cout + cout), out


def _act(name, c, hw):
    n = c * hw * hw
    return LayerProfile(name, float(n), n * BYTES_PER_ELT, 0)


def _pool(name, c, hw, k=2, s=2):
    out = hw // s
    return LayerProfile(name, float(c * out * out * k * k),
                        c * out * out * BYTES_PER_ELT, 0), out


def _fc(name, din, dout):
    return LayerProfile(name, 2.0 * din * dout, dout * BYTES_PER_ELT,
                        din * dout + dout)


# -- VGG (torchvision features indexing: conv,relu,[pool]) ------------------

_VGG_CFG = {
    "11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg(version: str) -> List[LayerProfile]:
    layers, cin, hw = [], 3, 224
    for v in _VGG_CFG[version]:
        if v == "M":
            l, hw = _pool(f"pool{len(layers)}", cin, hw)
            layers.append(l)
        else:
            l, hw = _conv(f"conv{len(layers)}", cin, v, 3, 1, hw)
            layers.append(l)
            layers.append(_act(f"relu{len(layers)}", v, hw))
            cin = v
    # classifier: fc-relu-fc-relu-fc (dropouts folded out)
    layers.append(_fc("fc1", cin * 7 * 7, 4096))
    layers.append(LayerProfile("relu_fc1", 4096.0, 4096 * BYTES_PER_ELT, 0))
    layers.append(_fc("fc2", 4096, 4096))
    layers.append(LayerProfile("relu_fc2", 4096.0, 4096 * BYTES_PER_ELT, 0))
    layers.append(_fc("fc3", 4096, 1000))
    return layers


# -- ResNet (block-level enumeration) ---------------------------------------

_RESNET_CFG = {
    "18": ("basic", [2, 2, 2, 2]),
    "50": ("bottleneck", [3, 4, 6, 3]),
}


def _resnet(version: str) -> List[LayerProfile]:
    kind, blocks = _RESNET_CFG[version]
    layers: List[LayerProfile] = []
    hw = 224
    l, hw = _conv("stem_conv", 3, 64, 7, 2, hw, p=3)
    layers.append(l)
    layers.append(_act("stem_relu", 64, hw))
    l, hw = _pool("stem_pool", 64, hw, k=3, s=2)
    layers.append(l)
    cin = 64
    widths = [64, 128, 256, 512]
    for stage, (w, n) in enumerate(zip(widths, blocks)):
        for b in range(n):
            s = 2 if (stage > 0 and b == 0) else 1
            if kind == "basic":
                l1, hw2 = _conv(f"s{stage}b{b}c1", cin, w, 3, s, hw)
                l2, _ = _conv(f"s{stage}b{b}c2", w, w, 3, 1, hw2)
                flops = l1.flops + l2.flops
                cout = w
            else:
                l1, hw1 = _conv(f"s{stage}b{b}c1", cin, w, 1, 1, hw, p=0)
                l2, hw2 = _conv(f"s{stage}b{b}c2", w, w, 3, s, hw1)
                l3, _ = _conv(f"s{stage}b{b}c3", w, 4 * w, 1, 1, hw2, p=0)
                flops = l1.flops + l2.flops + l3.flops
                cout = 4 * w
            if s == 2 or cin != cout:
                ld, _ = _conv(f"s{stage}b{b}ds", cin, cout, 1, s, hw, p=0)
                flops += ld.flops
            hw = hw // s
            layers.append(LayerProfile(
                f"s{stage}b{b}", flops, cout * hw * hw * BYTES_PER_ELT, 0))
            cin = cout
    layers.append(LayerProfile("gap", float(cin * hw * hw),
                               cin * BYTES_PER_ELT, 0))
    layers.append(_fc("fc", cin, 1000))
    return layers


# -- DenseNet (dense-block-level enumeration: 14 coarse ops) ----------------

_DENSENET_CFG = {
    "121": (32, [6, 12, 24, 16], 64),
    "161": (48, [6, 12, 36, 24], 96),
}


def _densenet(version: str) -> List[LayerProfile]:
    growth, blocks, init = _DENSENET_CFG[version]
    layers: List[LayerProfile] = []
    hw = 224
    l, hw = _conv("stem_conv", 3, init, 7, 2, hw, p=3)
    layers.append(l)
    layers.append(_act("stem_relu", init, hw))
    l, hw = _pool("stem_pool", init, hw, k=3, s=2)
    layers.append(l)
    cin = init
    for i, n in enumerate(blocks):
        flops = 0.0
        for b in range(n):
            l1, _ = _conv(f"d{i}b{b}c1", cin + b * growth, 4 * growth, 1, 1,
                          hw, p=0)
            l2, _ = _conv(f"d{i}b{b}c2", 4 * growth, growth, 3, 1, hw)
            flops += l1.flops + l2.flops
        cin = cin + n * growth
        layers.append(LayerProfile(f"dense{i}", flops,
                                   cin * hw * hw * BYTES_PER_ELT, 0))
        if i < len(blocks) - 1:
            lt, _ = _conv(f"t{i}", cin, cin // 2, 1, 1, hw, p=0)
            cin = cin // 2
            hw = hw // 2
            layers.append(LayerProfile(
                f"trans{i}", lt.flops, cin * hw * hw * BYTES_PER_ELT, 0))
        else:
            layers.append(LayerProfile("final_norm", float(cin * hw * hw),
                                       cin * hw * hw * BYTES_PER_ELT, 0))
    layers.append(LayerProfile("gap", float(cin * hw * hw),
                               cin * BYTES_PER_ELT, 0))
    layers.append(_fc("fc", cin, 1000))
    return layers


# --------------------------------------------------------------------------
# paper profiles (Table I cut points, published top-1 accuracies)
# --------------------------------------------------------------------------

_PAPER_ACC = {
    ("vgg", "11"): 0.690, ("vgg", "19"): 0.724,
    ("resnet", "18"): 0.698, ("resnet", "50"): 0.761,
    ("densenet", "121"): 0.744, ("densenet", "161"): 0.771,
}

_TABLE_I = {
    ("vgg", "11"): (3, 6, 11, 27),
    ("vgg", "19"): (5, 10, 19, 43),
    ("resnet", "18"): (4, 15, 20, 49),
    ("resnet", "50"): (4, 13, 20, 115),
    ("densenet", "121"): (4, 6, 8, 14),
    ("densenet", "161"): (4, 6, 8, 14),
}

_BUILDERS = {"vgg": _vgg, "resnet": _resnet, "densenet": _densenet}


def _clip_cuts(cuts: Sequence[int], n: int) -> Tuple[int, ...]:
    """Map Table I cut indices onto our op enumeration.

    The paper indexes torchvision's op-level module list; our profiles
    enumerate at (coarser) block level for ResNet/DenseNet. When the
    table's deepest index exceeds our layer count, map indices
    proportionally so each candidate lands at the same fractional depth.
    """
    if max(cuts) > n:
        scale = n / max(cuts)
        mapped = [max(1, round(c * scale)) for c in cuts]
        # de-duplicate while preserving order/monotonicity
        out = []
        for c in mapped:
            while c in out and c < n:
                c += 1
            out.append(min(c, n))
        return tuple(out)
    return tuple(min(c, n) for c in cuts)


# (model, version) pairs of the paper's Table I, in table order —
# public so each version's profile can be built on its own
PAPER_VERSIONS: Tuple[Tuple[str, str], ...] = tuple(_TABLE_I)


def paper_version_profile(model: str, version: str) -> VersionProfile:
    """Build one paper model version's layer profile + Table I cuts."""
    layers = tuple(_BUILDERS[model](version))
    cuts = _clip_cuts(_TABLE_I[(model, version)], len(layers))
    return VersionProfile(model, version, _PAPER_ACC[(model, version)],
                          layers, cuts)


def paper_profiles() -> Dict[str, ModelProfile]:
    out = {}
    for model, version in PAPER_VERSIONS:
        vp = paper_version_profile(model, version)
        if model not in out:
            out[model] = ModelProfile(model, (vp,))
        else:
            out[model] = ModelProfile(model, out[model].versions + (vp,))
    return out


# --------------------------------------------------------------------------
# transformer profiles (the adaptation to the assigned architectures)
# --------------------------------------------------------------------------

def build_quant_versions(cfg, per_layer, *, seq_len: int,
                         cuts: Tuple[int, ...],
                         flops_scale: float = 1.0
                         ) -> Tuple[VersionProfile, ...]:
    """One VersionProfile per quant-registry entry, derived from the real
    quantized execution path:

      accuracy     — baseline degraded by the version's measured
                     quantization error (quant.versions.accuracy_proxy)
      flops        — ``per_layer`` per-token FLOPs with the version's
                     matmul cost scale applied ONLY to the dense-projection
                     share (the part that executes int8 x int8);
                     attention scores, MoE experts and SSM/LRU mixers stay
                     full precision in execution and so in the tables.
                     ``flops_scale`` scales the whole block.
      out_bytes    — cut activation in the width the version ships:
                     int8 for w8a8, else the config's compute dtype
      weight_bytes — only the dense share prices at the version's code
                     width; everything quantize_tree leaves alone (MoE
                     experts, mixers, embeddings-free blocks) ships at
                     the config's param-dtype width
    """
    from repro_torch.core.transformer_cost import block_dense_flops, block_params
    from repro_torch.quant.versions import accuracy_proxy, get_version

    dense_share = block_dense_flops(cfg)           # quantizable share
    params_pl = block_params(cfg)
    pw = cfg.pdtype.itemsize                       # full-precision widths
    aw = cfg.cdtype.itemsize                       # (torch dtypes: 4 for f32)
    # accuracy, like FLOPs and bytes, only degrades on the quantized share
    dense_frac = sum(dense_share) / max(sum(per_layer), 1.0)
    versions = []
    for vname in cfg.versions:
        qv = get_version(vname)
        act_width = 1 if qv.act_bits == 8 else aw
        act_bytes = cfg.d_model * act_width * seq_len
        layers = []
        for i, (f, df, p) in enumerate(zip(per_layer, dense_share,
                                           params_pl)):
            flops = (df * qv.matmul_cost_scale + (f - df)) \
                * seq_len * flops_scale
            dense_p = df / 2.0
            if qv.mode is None:
                wb = p * pw
            else:
                wb = dense_p * qv.bytes_per_param + (p - dense_p) * pw
            layers.append(LayerProfile(f"block{i}", flops, act_bytes,
                                       int(p), weight_bytes=wb))
        versions.append(VersionProfile(
            cfg.name, vname, accuracy_proxy(qv, dense_frac=dense_frac),
            tuple(layers), cuts, bytes_per_param=qv.bytes_per_param))
    return tuple(versions)


def spread_cuts(n_layers: int, n_cuts: int) -> Tuple[int, ...]:
    """Candidate cut layers at even fractional depths."""
    return tuple(max(1, round(n_layers * (i + 1) / (n_cuts + 1)))
                 for i in range(n_cuts))


def transformer_profile(cfg, *, seq_len: int = 2048,
                        n_cuts: int = 4) -> ModelProfile:
    """Build an EdgeRL ModelProfile from a ModelConfig.

    Layer = one decoder block; activation at the cut = (seq, d_model).
    The version axis is the *quantization level* of the same trunk
    (repro_torch.quant: bf16 / w8 / w4) — the transformer analogue of the
    paper's compressed variants — with every table entry derived from the
    real quantized execution path (see build_quant_versions).
    """
    from repro_torch.core.transformer_cost import block_flops_per_token

    per_layer = block_flops_per_token(cfg)         # list, len n_layers
    cuts = spread_cuts(len(per_layer), n_cuts)
    versions = build_quant_versions(cfg, per_layer, seq_len=seq_len,
                                    cuts=cuts)
    return ModelProfile(cfg.name, versions)
