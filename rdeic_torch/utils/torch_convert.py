"""SD 2.1 PyTorch checkpoint -> the port's state dict (counterpart of
rdeic_tpu/utils/torch_convert.py).

The reference loads a composite checkpoint: the SD 2.1 base weights, then
the compression-and-control weights, with the control module's weights
synced from the base UNet's by tiling and truncation where the widths
differ, and DDP `module.` prefixes stripped. The map is a function from a
parameter's flax path to its SD state-dict key and a layout transform
(`torch_key_for`), a copy of the JAX package's. The converter walks the
port model's own state dict, so every tensor either converts or is
reported in `missing`, string for string as the JAX converter reports it.

Each converted leaf is laid out as the JAX package lays it (the transforms
below: SD [O, I, kh, kw] -> HWIO, [O, I] -> (in, out), norms copied), then
carried into the port's layout by utils/convert.py's one rule
(`convert_leaf`), so a converted tensor equals the JAX conversion carried
across by `load_jax_params`.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from rdeic_torch.utils.convert import convert_leaf
from rdeic_torch.utils.fast_init import flax_path


def _t_conv(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _t_linear(w):
    return np.transpose(np.asarray(w), (1, 0))


def _t_copy(w):
    return np.asarray(w)


# ---------------------------------------------------------------------------
# path -> (torch key suffix, transform)
# ---------------------------------------------------------------------------
def _unet_resblock(rest: list[str], base: str):
    """rest like ['in_norm','GroupNorm_0','scale'] under a torch ResBlock."""
    head = rest[0]
    leaf = rest[-1]
    if head == "in_norm":
        return f"{base}.in_layers.0.{_norm_leaf(leaf)}", _t_copy
    if head == "in_conv":
        return f"{base}.in_layers.2.{_wb(leaf)}", _t_conv if leaf == "kernel" else _t_copy
    if head == "emb_proj":
        return f"{base}.emb_layers.1.{_wb(leaf)}", _t_linear if leaf == "kernel" else _t_copy
    if head == "out_norm":
        return f"{base}.out_layers.0.{_norm_leaf(leaf)}", _t_copy
    if head == "out_conv":
        return f"{base}.out_layers.3.{_wb(leaf)}", _t_conv if leaf == "kernel" else _t_copy
    if head == "skip":
        return f"{base}.skip_connection.{_wb(leaf)}", _t_conv if leaf == "kernel" else _t_copy
    raise KeyError(f"unknown resblock leaf {rest}")


def _unet_transformer(rest: list[str], base: str):
    """rest under a torch SpatialTransformer."""
    head = rest[0]
    leaf = rest[-1]
    if head == "norm":
        return f"{base}.norm.{_norm_leaf(leaf)}", _t_copy
    if head == "proj_in":
        return f"{base}.proj_in.{_wb(leaf)}", _t_linear if leaf == "kernel" else _t_copy
    if head == "proj_out":
        return f"{base}.proj_out.{_wb(leaf)}", _t_linear if leaf == "kernel" else _t_copy
    if head.startswith("block_"):
        bi = head.split("_")[1]
        tb = f"{base}.transformer_blocks.{bi}"
        sub = rest[1]
        if sub in ("attn1", "attn2"):
            proj = rest[2]
            if proj == "to_out":
                return f"{tb}.{sub}.to_out.0.{_wb(leaf)}", (
                    _t_linear if leaf == "kernel" else _t_copy
                )
            return f"{tb}.{sub}.{proj}.{_wb(leaf)}", (
                _t_linear if leaf == "kernel" else _t_copy
            )
        if sub == "ff_geglu":
            return f"{tb}.ff.net.0.proj.{_wb(leaf)}", (
                _t_linear if leaf == "kernel" else _t_copy
            )
        if sub == "ff_out":
            return f"{tb}.ff.net.2.{_wb(leaf)}", (
                _t_linear if leaf == "kernel" else _t_copy
            )
        if sub in ("norm1", "norm2", "norm3"):
            return f"{tb}.{sub}.{_norm_leaf(leaf)}", _t_copy
    raise KeyError(f"unknown transformer leaf {rest}")


def _wb(leaf: str) -> str:
    return {"kernel": "weight", "bias": "bias"}[leaf]


def _norm_leaf(leaf: str) -> str:
    return {"scale": "weight", "bias": "bias"}[leaf]


def _unet_block(path: list[str], prefix: str, dec_upsample_pos: dict):
    """Map one base/control UNet leaf path to its torch key."""
    head = path[0]
    leaf = path[-1]
    if head == "time_embed":
        idx = {"fc1": "0", "fc2": "2"}[path[1]]
        return f"{prefix}.time_embed.{idx}.{_wb(leaf)}", (
            _t_linear if leaf == "kernel" else _t_copy
        )
    if head == "out_norm":
        return f"{prefix}.out.0.{_norm_leaf(leaf)}", _t_copy
    if head == "out_conv":
        return f"{prefix}.out.2.{_wb(leaf)}", _t_conv if leaf == "kernel" else _t_copy
    if head.startswith("in_"):
        i = int(head[3:])
        sub = path[1]
        if sub == "conv_in":
            return f"{prefix}.input_blocks.{i}.0.{_wb(leaf)}", (
                _t_conv if leaf == "kernel" else _t_copy
            )
        if sub == "down":
            return f"{prefix}.input_blocks.{i}.0.op.{_wb(leaf)}", (
                _t_conv if leaf == "kernel" else _t_copy
            )
        if sub == "res":
            return _unet_resblock(path[2:], f"{prefix}.input_blocks.{i}.0")
        if sub == "attn":
            return _unet_transformer(path[2:], f"{prefix}.input_blocks.{i}.1")
    if head == "mid":
        sub = path[1]
        if sub == "res1":
            return _unet_resblock(path[2:], f"{prefix}.middle_block.0")
        if sub == "attn":
            return _unet_transformer(path[2:], f"{prefix}.middle_block.1")
        if sub == "res2":
            return _unet_resblock(path[2:], f"{prefix}.middle_block.2")
    if head.startswith("out_"):
        i = int(head[4:])
        sub = path[1]
        if sub == "res":
            return _unet_resblock(path[2:], f"{prefix}.output_blocks.{i}.0")
        if sub == "attn":
            return _unet_transformer(path[2:], f"{prefix}.output_blocks.{i}.1")
        if sub == "up":
            pos = dec_upsample_pos[i]
            return f"{prefix}.output_blocks.{i}.{pos}.conv.{_wb(leaf)}", (
                _t_conv if leaf == "kernel" else _t_copy
            )
    raise KeyError(f"unknown unet path {path}")


def _vae_block(path: list[str]):
    leaf = path[-1]
    head = path[0]
    prefix = "first_stage_model"
    conv_t = _t_conv if leaf == "kernel" else _t_copy

    def resnet(rest, base):
        sub = rest[0]
        if sub in ("norm1", "norm2"):
            return f"{base}.{sub}.{_norm_leaf(leaf)}", _t_copy
        if sub in ("conv1", "conv2", "nin_shortcut"):
            return f"{base}.{sub}.{_wb(leaf)}", conv_t
        raise KeyError(rest)

    def attn(rest, base):
        sub = rest[0]
        if sub == "norm":
            return f"{base}.norm.{_norm_leaf(leaf)}", _t_copy
        return f"{base}.{sub}.{_wb(leaf)}", conv_t

    if head in ("quant_conv", "post_quant_conv"):
        return f"{prefix}.{head}.{_wb(leaf)}", conv_t
    tower = head  # encoder | decoder
    sub = path[1]
    base = f"{prefix}.{tower}"
    if sub == "conv_in" or sub == "conv_out":
        return f"{base}.{sub}.{_wb(leaf)}", conv_t
    if sub == "norm_out":
        return f"{base}.norm_out.{_norm_leaf(leaf)}", _t_copy
    if sub.startswith("down_"):
        parts = sub.split("_")
        i = parts[1]
        if parts[2] == "block":
            return resnet(path[2:], f"{base}.down.{i}.block.{parts[3]}")
        if parts[2] == "downsample":
            return f"{base}.down.{i}.downsample.conv.{_wb(leaf)}", conv_t
    if sub.startswith("up_"):
        parts = sub.split("_")
        i = parts[1]
        if parts[2] == "block":
            return resnet(path[2:], f"{base}.up.{i}.block.{parts[3]}")
        if parts[2] == "upsample":
            return f"{base}.up.{i}.upsample.conv.{_wb(leaf)}", conv_t
    if sub.startswith("mid_block"):
        n = sub.split("_")[-1]
        return resnet(path[2:], f"{base}.mid.block_{n}")
    if sub.startswith("mid_attn"):
        return attn(path[2:], f"{base}.mid.attn_1")
    raise KeyError(f"unknown vae path {path}")


_COMP_SEQ = {
    # module attr -> (torch seq name, layout of our auto-names -> indices)
    "encoder": ("encoder.g_a", ["ResidualBlock_0", "ResidualBlock_1",
                                "ResidualBlock_2", "ResidualBlock_3",
                                "ResidualBlockWithStride_0", "ResidualBlock_4",
                                "ResidualBlock_5", "ResidualBlock_6",
                                "conv_out"]),
    "decoder": ("decoder.g_s", ["conv_in", "ResidualBlock_0", "ResidualBlock_1",
                                "ResidualBlock_2", "ResidualBlockUpsample_0",
                                "ResidualBlock_3", "ResidualBlock_4",
                                "ResidualBlock_5", "ResidualBlock_6"]),
    "hyper_enc": ("hyper_enc.hyper_enc", ["ResidualBlock_0", "ResidualBlock_1",
                                          "ResidualBlockWithStride_0",
                                          "ResidualBlockWithStride_1"]),
    "hyper_dec": ("hyper_dec.hyper_dec", ["ResidualBlockUpsample_0",
                                          "ResidualBlockUpsample_1",
                                          "ResidualBlock_0", "ResidualBlock_1"]),
}


def _compression_block(path: list[str]):
    leaf = path[-1]
    prefix = "preprocess_model"
    conv_t = _t_conv if leaf == "kernel" else _t_copy
    head = path[0]
    if head == "quantize":
        return f"{prefix}.quantize.embedding.weight", _t_copy
    if head == "out":
        return f"{prefix}.out.{_wb(leaf)}", conv_t
    if head.startswith("local_context_"):
        i = head.rsplit("_", 1)[1]
        return f"{prefix}.local_context.{i}.{_wb(leaf)}", conv_t
    if head.startswith("channel_context_"):
        i = head.rsplit("_", 1)[1]
        ci = {"conv1": 0, "conv2": 2, "conv3": 4}[path[1]]
        return f"{prefix}.channel_context.{i}.fushion.{ci}.{_wb(leaf)}", conv_t
    if head.startswith("ep_anchor_") or head.startswith("ep_nonanchor_"):
        i = head.rsplit("_", 1)[1]
        name = (
            "entropy_parameters_anchor"
            if head.startswith("ep_anchor")
            else "entropy_parameters_nonanchor"
        )
        ci = {"conv1": 0, "conv2": 2, "conv3": 4}[path[1]]
        return f"{prefix}.{name}.{i}.fusion.{ci}.{_wb(leaf)}", conv_t
    if head in _COMP_SEQ:
        seq_name, layout = _COMP_SEQ[head]
        idx = layout.index(path[1])
        base = f"{prefix}.{seq_name}.{idx}"
        if path[1].startswith("conv_"):  # bare conv in the sequence
            return f"{base}.{_wb(leaf)}", conv_t
        sub = path[2]
        if sub in ("conv1", "conv2", "adaptor", "downsample", "conv"):
            return f"{base}.{sub}.{_wb(leaf)}", conv_t
        if sub == "subpel_conv":
            return f"{base}.subpel_conv.0.{_wb(leaf)}", conv_t
        if sub == "upsample":
            return f"{base}.upsample.0.{_wb(leaf)}", conv_t
    raise KeyError(f"unknown compression path {path}")


def _clip_block(path: list[str]):
    leaf = path[-1]
    prefix = "cond_stage_model.model"
    head = path[0]
    if head == "token_embedding":
        return f"{prefix}.token_embedding.weight", _t_copy
    if head == "positional_embedding":
        return f"{prefix}.positional_embedding", _t_copy
    if head == "ln_final":
        return f"{prefix}.ln_final.{_norm_leaf(leaf)}", _t_copy
    if head.startswith("resblock_"):
        i = head.split("_")[1]
        base = f"{prefix}.transformer.resblocks.{i}"
        sub = path[1]
        lin_t = _t_linear if leaf == "kernel" else _t_copy
        if sub in ("ln_1", "ln_2"):
            return f"{base}.{sub}.{_norm_leaf(leaf)}", _t_copy
        if sub == "in_proj":
            key = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
            return f"{base}.attn.{key}", lin_t
        if sub == "out_proj":
            return f"{base}.attn.out_proj.{_wb(leaf)}", lin_t
        if sub == "mlp_fc":
            return f"{base}.mlp.c_fc.{_wb(leaf)}", lin_t
        if sub == "mlp_proj":
            return f"{base}.mlp.c_proj.{_wb(leaf)}", lin_t
    raise KeyError(f"unknown clip path {path}")


def torch_key_for(path: tuple, dec_upsample_pos: dict) -> tuple[str, Callable]:
    """Our param path -> (torch state-dict key, transform)."""
    parts = [str(p) for p in path]
    top = parts[0]
    if top == "vae":
        return _vae_block(parts[1:])
    if top == "compression":
        return _compression_block(parts[1:])
    if top == "clip":
        return _clip_block(parts[1:])
    if top == "vq_embed_prob":
        return "preprocess_model.quantize.embed_prob", _t_copy
    if top == "denoiser":
        sub = parts[1]
        leaf = parts[-1]
        conv_t = _t_conv if leaf == "kernel" else _t_copy
        if sub == "base":
            return _unet_block(parts[2:], "model.diffusion_model", dec_upsample_pos)
        if sub == "control":
            return _unet_block(
                parts[2:], "control_model.control_model", dec_upsample_pos
            )
        if sub.startswith("enc_zero_convs_out_"):
            i = sub.rsplit("_", 1)[1]
            return f"control_model.enc_zero_convs_out.{i}.0.{_wb(leaf)}", conv_t
        if sub.startswith("dec_zero_convs_out_"):
            i = sub.rsplit("_", 1)[1]
            return f"control_model.dec_zero_convs_out.{i}.0.{_wb(leaf)}", conv_t
        if sub == "middle_block_out":
            return f"control_model.middle_block_out.0.{_wb(leaf)}", conv_t
    raise KeyError(f"unknown top-level path {path}")


def dec_upsample_positions(model) -> dict:
    """output_blocks index -> position of the Upsample inside SD's
    TimestepEmbedSequential (1 without attention, 2 with), from the port's
    base UNet."""
    blocks = model.denoiser.base.output_blocks
    return {i: (2 if b.attn is not None else 1)
            for i, b in enumerate(blocks) if b.up is not None}


def normalize_state_dict(sd: dict) -> dict:
    """Unwrap nested 'state_dict' and strip DDP 'module.' prefixes
    (utils/common.py:34-50 behavior)."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module.") :]
        out[k] = v
    return out


def _tile_truncate(src: np.ndarray, target_shape: tuple) -> Optional[np.ndarray]:
    """Reference-style control-weight fitting (rdeic.py:962-991): duplicate
    along dims 0/1 then truncate. Returns None if the shapes can't be fit."""
    src = np.asarray(src)
    if src.shape == tuple(target_shape):
        return src
    if src.ndim != len(target_shape):
        return None
    out = src
    for dim in range(min(2, src.ndim)):
        if out.shape[dim] < target_shape[dim]:
            reps = [1] * out.ndim
            reps[dim] = -(-target_shape[dim] // out.shape[dim])
            out = np.tile(out, reps)
        out = np.take(out, range(target_shape[dim]), axis=dim)
    return out if out.shape == tuple(target_shape) else None


def convert_state_dict(state_dict: dict, model: torch.nn.Module,
                       sync_control: bool = False, strict: bool = False,
                       used_keys: Optional[set] = None
                       ) -> tuple[dict, list[str]]:
    """The tensors of `model`'s state dict that `state_dict` (an SD 2.1
    torch state dict) holds: ({port key: fp32 tensor}, missing). `model`
    may live on `meta`: only its names and shapes are read. `missing` lists
    each leaf left as it is: without a map, absent from the checkpoint, or
    of a shape tiling cannot fit. With `sync_control`, control-module
    leaves absent from the checkpoint take the base UNet's weights, tiled
    along the out and in channels and truncated (rdeic.py:962-991). The
    stored context and LPIPS are never converted. `used_keys` collects every
    checkpoint key read."""
    sd = normalize_state_dict(state_dict)
    try:
        dec_pos = dec_upsample_positions(model)
    except AttributeError:
        dec_pos = {}  # no denoiser in this model
    out, missing = {}, []
    for name, tensor in model.state_dict(keep_vars=True).items():
        path, leaf_shape = flax_path(name, tensor)
        if path[0] in ("uncond_context", "lpips"):
            continue
        try:
            key, transform = torch_key_for(path, dec_pos)
        except KeyError:
            missing.append("/".join(path))
            continue
        # the target shape in the SD layout (tiling runs along its dims 0
        # and 1, the out and in channels)
        if transform is _t_conv:
            torch_shape = (leaf_shape[3], leaf_shape[2], leaf_shape[0],
                           leaf_shape[1])
        elif transform is _t_linear:
            torch_shape = (leaf_shape[1], leaf_shape[0])
        else:
            torch_shape = leaf_shape
        src = None
        if key in sd:
            src = _as_np(sd[key])
            if used_keys is not None:
                used_keys.add(key)
        elif sync_control and key.startswith("control_model.control_model."):
            base_key = ("model.diffusion_model."
                        + key[len("control_model.control_model."):])
            if base_key in sd:
                src = _as_np(sd[base_key])
                if used_keys is not None:
                    used_keys.add(base_key)
        if src is None:
            missing.append("/".join(path) + f" <- {key}")
            continue
        if tuple(src.shape) != torch_shape:
            src = _tile_truncate(src, torch_shape)
            if src is None:
                missing.append("/".join(path) + f" <- {key} (shape mismatch)")
                continue
        _, value = convert_leaf("/".join(path),
                                transform(src).astype(np.float32))
        out[name] = value
    if strict and missing:
        raise KeyError(f"{len(missing)} unconverted leaves, e.g. {missing[:5]}")
    return out, missing


def _as_np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def load_torch_checkpoint(path: str) -> dict:
    """The normalized state dict of a torch checkpoint file."""
    return normalize_state_dict(torch.load(path, map_location="cpu"))
