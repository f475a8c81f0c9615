"""Analytic FLOP counts for the UNet forward pass: the MFU numerator.

The counterpart of chiaswarm_tpu/models/flops.py, copied and read from
the port's own configs (models/configs.py, the same widths). Counts
mirror `unet2d.py` / `layers.py` (convs as 2*K*K*Cin*Cout*H*W, matmuls as
2*M*N*K, attention as 2*S*S_kv*inner twice). Elementwise and norm work is
omitted (bandwidth-bound, not FLOP-bound), and so are the time and added-
condition embeddings' small linears: programs.py checks the count against
`torch.utils.flop_counter` on the first UNet call of every pass key.
"""

from __future__ import annotations

from .unet2d import UNet2DConfig


def _resnet(cin: int, cout: int, s: int, temb_dim: int) -> float:
    f = 2 * 9 * cin * cout * s  # conv1
    f += 2 * 9 * cout * cout * s  # conv2
    f += 2 * temb_dim * cout  # time_emb_proj (per batch row, no spatial)
    if cin != cout:
        f += 2 * cin * cout * s  # 1x1 shortcut
    return f


def _transformer(ch: int, n_layers: int, s: int, ctx_len: int,
                 cross_dim: int) -> float:
    f = 2 * 2 * ch * ch * s  # proj_in + proj_out
    per_layer = 0.0
    # self-attention: q,k,v,out projections + scores + weighted sum
    per_layer += 4 * 2 * ch * ch * s
    per_layer += 2 * 2 * s * s * ch
    # cross-attention: q,out on ch; k,v on cross_dim; attn over ctx_len
    per_layer += 2 * 2 * ch * ch * s
    per_layer += 2 * 2 * cross_dim * ch * ctx_len
    per_layer += 2 * 2 * s * ctx_len * ch
    # GEGLU MLP: proj to 2*4ch, gate, project back
    per_layer += 2 * ch * (8 * ch) * s + 2 * (4 * ch) * ch * s
    return f + n_layers * per_layer


def unet_call_flops(cfg: UNet2DConfig, lh: int, lw: int, batch: int,
                    ctx_len: int = 77) -> float:
    """FLOPs of ONE UNet2DConditionModel.__call__ on [batch, lh, lw, C]."""
    chans = cfg.block_out_channels
    temb_dim = chans[0] * 4
    s0 = lh * lw
    f = 2 * 9 * cfg.in_channels * chans[0] * s0  # conv_in

    # down path: level b runs at spatial s0 / 4^b
    skip_specs = [(chans[0], 0)]  # (channels, level) for each skip tensor
    in_ch = chans[0]
    for b, out_ch in enumerate(chans):
        s = s0 // (4 ** b)
        for _ in range(cfg.layers_per_block):
            f += _resnet(in_ch, out_ch, s, temb_dim)
            if cfg.transformer_layers[b] > 0:
                f += _transformer(out_ch, cfg.transformer_layers[b], s,
                                  ctx_len, cfg.cross_attention_dim)
            in_ch = out_ch
            skip_specs.append((out_ch, b))
        if b != len(chans) - 1:
            f += 2 * 9 * out_ch * out_ch * (s // 4)  # strided downsample conv
            skip_specs.append((out_ch, b + 1))

    # mid block at the deepest level
    s_mid = s0 // (4 ** (len(chans) - 1))
    mid_ch = chans[-1]
    f += 2 * _resnet(mid_ch, mid_ch, s_mid, temb_dim)
    f += _transformer(mid_ch, cfg.mid_transformer_layers, s_mid, ctx_len,
                      cfg.cross_attention_dim)

    # up path: concatenated skips make the resnet input wider
    x_ch = mid_ch
    for b, out_ch in enumerate(reversed(chans)):
        rev = len(chans) - 1 - b
        for _ in range(cfg.layers_per_block + 1):
            skip_ch, skip_level = skip_specs.pop()
            s = s0 // (4 ** skip_level)
            f += _resnet(x_ch + skip_ch, out_ch, s, temb_dim)
            if cfg.transformer_layers[rev] > 0:
                f += _transformer(out_ch, cfg.transformer_layers[rev], s,
                                  ctx_len, cfg.cross_attention_dim)
            x_ch = out_ch
        if b != len(chans) - 1:
            s_up = s0 // (4 ** (rev - 1))
            f += 2 * 9 * out_ch * out_ch * s_up  # post-resize conv

    f += 2 * 9 * chans[0] * cfg.out_channels * s0  # conv_out
    return float(f) * batch


def denoise_flops(cfg: UNet2DConfig, lh: int, lw: int, n_images: int,
                  steps: int, ctx_len: int = 77, cfg_rows: int = 2) -> float:
    """FLOPs of a full CFG denoise loop (batch is cfg_rows*N per step;
    2 for standard CFG, 3 for instruct-pix2pix dual guidance)."""
    return unet_call_flops(cfg, lh, lw, cfg_rows * n_images, ctx_len) * steps
