"""SAM prompt encoder, two-way transformer and GROVE box/objectness heads.

Counterpart of `grove_tpu/models/sam_decoder.py` with the reference module
tree (`model.grounding_encoder.{prompt_encoder,mask_decoder}.*`). Every
(frame, phrase) pair is one decoder instance whose token sequence is
[iou_token, 4 mask_tokens, text_embed] (`mask_decoder.py:164-199`).

`PromptEncoder` embeds any mix of text, points, boxes and a mask input;
`GroveBoxDecoder.forward` runs the box + objectness heads (the GROVE
path) and `predict_masks` the legacy SAM mask path (upscaling,
hypernetwork MLPs, IoU head), which `GroveModel.segment` drives.

The mask path's two `ConvTranspose2d` keep torch's semantics on the
reference's (in, out, kh, kw) weights, so a reference checkpoint computes
as the reference does. The JAX package loads those weights with a plain
transpose into flax's `nn.ConvTranspose`, which does not flip the kernel
(`torch_convert.py:43-45`): its masks equal the port's only with the 2x2
kernels flipped in both spatial axes (a JAX fault, ROADMAP).

LayerNorms use eps = 1e-6, the flax default the JAX package runs with
(the reference's torch modules use 1e-5).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SamDecoderConfig
from .layers import MLP, LayerNorm2d, MLPBlock

_LN_EPS = 1e-6


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (`prompt_encoder.py:189-238`)."""

    def __init__(self, num_pos_feats: int = 128, *, device=None, dtype=None):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.zeros(2, num_pos_feats, device=device, dtype=dtype))

    def forward(self, coords):                          # (..., 2) in [0, 1]
        c = 2.0 * coords.float() - 1.0
        c = c @ self.positional_encoding_gaussian_matrix.float()
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid_pe(self, size: Tuple[int, int]):
        """Dense PE for an (h, w) grid -> (h, w, 2 * num_pos_feats), fp32."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
        return self(grid)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        c, mc = cfg.embed_dim, cfg.mask_in_chans
        self.cfg = cfg
        self.pe_layer = PositionEmbeddingRandom(c // 2, **f)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, c, **f)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, c, **f)
        self.no_mask_embed = nn.Embedding(1, c, **f)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, stride=2, **f),
            LayerNorm2d(mc // 4, **f), nn.GELU(),
            nn.Conv2d(mc // 4, mc, 2, stride=2, **f),
            LayerNorm2d(mc, **f), nn.GELU(),
            nn.Conv2d(mc, c, 1, **f))

    def get_dense_pe(self):
        g = self.cfg.image_embedding_size
        return self.pe_layer.grid_pe((g, g))            # (g, g, C) fp32

    def embed_points(self, points, labels, pad: bool = True):
        """points (N, K, 2) pixel xy; labels (N, K) in {-1, 0, 1}
        (`sam_decoder.py:86-103`): shifted to pixel centres, a
        not-a-point appended when `pad` (no box follows), label -1 takes
        the not-a-point embedding in place of its PE, 0 and 1 add the
        negative and positive embeddings. Returns (N, K (+1), C) fp32."""
        dev = self.no_mask_embed.weight.device
        points = torch.as_tensor(points, device=dev).float() + 0.5
        labels = torch.as_tensor(labels, device=dev)
        if pad:
            points = torch.cat([points, torch.zeros_like(points[:, :1])], 1)
            labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], 1)
        pe = self.pe_layer(points / self.cfg.input_image_size)
        lab = labels[..., None]
        emb = [e.weight[0].float() for e in self.point_embeddings]
        zero = torch.zeros((), device=dev)
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0].float(),
                         pe)
        pe = pe + torch.where(lab == 0, emb[0], zero)
        return pe + torch.where(lab == 1, emb[1], zero)

    def embed_boxes(self, boxes):
        """boxes (N, 4) xyxy pixels -> (N, 2, C) fp32 corner embeddings
        (`sam_decoder.py:105-112`)."""
        dev = self.no_mask_embed.weight.device
        boxes = torch.as_tensor(boxes, device=dev).float()
        coords = (boxes + 0.5).reshape(-1, 2, 2) / self.cfg.input_image_size
        corners = torch.stack([self.point_embeddings[2].weight[0],
                               self.point_embeddings[3].weight[0]]).float()
        return self.pe_layer(coords) + corners

    def embed_masks(self, masks):
        """(N, 4g, 4g, 1) mask inputs -> (N, g, g, C) dense embeddings
        (`sam_decoder.py:114-120`: 2x2 stride-2 convs, LayerNorm2d and
        exact GELU, then a 1x1 conv)."""
        w = self.no_mask_embed.weight
        x = torch.as_tensor(masks, device=w.device).to(w.dtype)
        return self.mask_downscaling(x.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)

    def forward(self, text_embeds=None, points=None, point_labels=None,
                boxes=None, masks=None):
        """Any mix of prompts (`sam_decoder.py:122-147`) -> (sparse (N, K,
        C): points, then box corners, then text; dense: the mask input's
        embedding (N, g, g, C), or the no-mask embedding over the grid (g,
        g, C)), both in the model dtype. The GROVE path passes only
        `text_embeds` (N, 1, C)."""
        w = self.no_mask_embed.weight
        parts = []
        if points is not None:
            parts.append(self.embed_points(points, point_labels,
                                           pad=boxes is None))
        if boxes is not None:
            parts.append(self.embed_boxes(boxes))
        if text_embeds is not None:
            parts.append(text_embeds.float())
        if not parts:
            raise ValueError("a prompt needs text, points or boxes (the "
                             "JAX package has no mask-only prompt)")
        sparse = torch.cat(parts, dim=1).to(w.dtype)
        if masks is not None:
            return sparse, self.embed_masks(masks)
        g = self.cfg.image_embedding_size
        return sparse, w[0].expand(g, g, self.cfg.embed_dim)


class DownsampleAttention(nn.Module):
    """Attention with projection to embed_dim / downsample_rate
    (`transformer.py:185-242`); fp32 softmax."""

    def __init__(self, embed_dim: int, num_heads: int,
                 downsample_rate: int = 1, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        internal = embed_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, internal, **f)
        self.k_proj = nn.Linear(embed_dim, internal, **f)
        self.v_proj = nn.Linear(embed_dim, internal, **f)
        self.out_proj = nn.Linear(internal, embed_dim, **f)

    def forward(self, q, k, v):
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, nq, internal = qp.shape
        nk = kp.shape[1]
        nh = self.num_heads
        hd = internal // nh
        qh = qp.reshape(b, nq, nh, hd)
        kh = kp.reshape(b, nk, nh, hd)
        vh = vp.reshape(b, nk, nh, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
        probs = torch.softmax(logits / math.sqrt(hd), dim=-1).to(vh.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
        return self.out_proj(out.reshape(b, nq, internal))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, skip_first_layer_pe: bool,
                 *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        c, nh = cfg.embed_dim, cfg.num_heads
        rate = cfg.attention_downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampleAttention(c, nh, 1, **f)
        self.norm1 = nn.LayerNorm(c, eps=_LN_EPS, **f)
        self.cross_attn_token_to_image = DownsampleAttention(c, nh, rate, **f)
        self.norm2 = nn.LayerNorm(c, eps=_LN_EPS, **f)
        self.mlp = MLPBlock(c, cfg.mlp_dim, act=F.relu, **f)
        self.norm3 = nn.LayerNorm(c, eps=_LN_EPS, **f)
        self.norm4 = nn.LayerNorm(c, eps=_LN_EPS, **f)
        self.cross_attn_image_to_token = DownsampleAttention(c, nh, rate, **f)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            # the reference replaces the queries here, no residual
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries
                             + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, skip_first_layer_pe=(i == 0), **f)
            for i in range(cfg.depth))
        self.final_attn_token_to_image = DownsampleAttention(
            cfg.embed_dim, cfg.num_heads, cfg.attention_downsample_rate, **f)
        self.norm_final_attn = nn.LayerNorm(cfg.embed_dim, eps=_LN_EPS, **f)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding/image_pe (N, HW, C); point_embedding (N, T, C)."""
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class GroveBoxDecoder(nn.Module):
    """SAM mask decoder with GROVE's query box/objectness heads
    (reference `mask_decoder`, decoding_type="query")."""

    def __init__(self, cfg: SamDecoderConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        c = cfg.embed_dim
        self.cfg = cfg
        self.iou_token = nn.Embedding(1, c, **f)
        self.mask_tokens = nn.Embedding(cfg.num_mask_tokens, c, **f)
        self.transformer = TwoWayTransformer(cfg, **f)
        self.bbox_prediction_head = nn.Sequential(
            nn.Linear(c, c, **f), nn.ReLU(), nn.Linear(c, 4, **f))
        if cfg.use_temp_objectness:
            self.temporal_objectness_head = nn.Linear(c, 1, **f)
        # legacy mask path (`mask_decoder.py:57-77`)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, stride=2, **f),
            LayerNorm2d(c // 4, **f), nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2, **f), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(c, c, c // 8, 3, **f) for _ in range(cfg.num_mask_tokens))
        self.iou_prediction_head = MLP(c, cfg.iou_head_hidden_dim,
                                       cfg.num_mask_tokens,
                                       cfg.iou_head_depth, **f)

    def _run_transformer(self, image_embeddings, image_pe,
                         sparse_embeddings, dense_embeddings):
        """Tokens [iou, mask tokens, sparse] against the image embeddings
        plus the dense embeddings (one grid for all, or one per instance)
        -> (hs (N, T, C), keys (N, HW, C))."""
        cfg = self.cfg
        dt = image_embeddings.dtype
        n = sparse_embeddings.shape[0]
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], dim=0)
        out_tokens = out_tokens.to(dt)[None].expand(n, -1, -1)
        tokens = torch.cat([out_tokens, sparse_embeddings.to(dt)], dim=1)
        hw = image_embeddings.shape[1]
        src = image_embeddings + dense_embeddings.reshape(-1, hw,
                                                          cfg.embed_dim)
        pos = image_pe.reshape(1, hw, cfg.embed_dim).to(dt).expand_as(src)
        return self.transformer(src, pos, tokens)

    def forward(self, image_embeddings, image_pe, sparse_embeddings,
                dense_embeddings):
        """image_embeddings (N, HW, C) per instance; image_pe (g, g, C);
        sparse (N, 1, C); dense (g, g, C). Returns (boxes (N, 4) sigmoid
        cxcywh, objectness logits (N,) or None)."""
        cfg = self.cfg
        hs, _ = self._run_transformer(image_embeddings, image_pe,
                                      sparse_embeddings, dense_embeddings)
        query_out = hs[:, 1 + cfg.num_mask_tokens:, :]   # (N, 1, C)
        boxes = torch.sigmoid(self.bbox_prediction_head(query_out))[:, 0, :]
        obj = None
        if cfg.use_temp_objectness:
            obj = self.temporal_objectness_head(query_out)[:, 0, 0]
        return boxes, obj

    def predict_masks(self, image_embeddings, image_pe, sparse_embeddings,
                      dense_embeddings, multimask_output: bool = False):
        """Legacy SAM mask outputs (`sam_decoder.py:330-354`): the attended
        image embedding upscaled 4x (ConvTranspose2d, LayerNorm2d, GELU,
        ConvTranspose2d, GELU; exact GELU), dotted with the mask tokens'
        hypernetwork MLPs, and the IoU head on the iou token. Arguments as
        `forward`'s, dense also (N, g, g, C). Returns (masks (N, 1 or 3,
        4g, 4g) logits, iou predictions (N, 1 or 3)): the first mask
        token, or with `multimask_output` the other three."""
        cfg = self.cfg
        g, m = cfg.image_embedding_size, cfg.num_mask_tokens
        hs, keys = self._run_transformer(image_embeddings, image_pe,
                                         sparse_embeddings, dense_embeddings)
        src = keys.reshape(-1, g, g, cfg.embed_dim).permute(0, 3, 1, 2)
        up = self.output_upscaling(src)                  # (N, C/8, 4g, 4g)
        hyper_in = torch.stack([mlp(hs[:, 1 + i])
                                for i, mlp in enumerate(
                                    self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("nmc,nchw->nmhw", hyper_in, up)
        iou = self.iou_prediction_head(hs[:, 0])
        keep = slice(1, m) if multimask_output else slice(0, 1)
        return masks[:, keep], iou[:, keep]
