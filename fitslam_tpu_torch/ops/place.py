"""Place recognition (port of ``fitslam_tpu/ops/place.py``): the keyframe
signature and the retrieval scores of loop detection and relocalization.

The vocabulary is the port's copy of the reference's committed k-means file,
``fitslam_tpu_torch/data/vocab_kmeans_256.npz`` (byte-equal to
``fitslam_tpu/data/vocab_kmeans_256.npz``; a test holds them so). The
reference's seeded ``jax.random`` fallback vocabulary cannot be reproduced
in torch (ROADMAP fault F4), so a missing file raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.utils.transfer import upload

VOCAB_WORDS = 256
TRAINED_BETA = 0.15
VOCAB_FILE = Path(__file__).resolve().parents[1] / "data" / "vocab_kmeans_256.npz"

_vocab_cache: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _trained_vocabulary(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C (W, bits) float32 centroids, half squared norms (W,)) on ``device``."""
    device = torch.device(device)
    if device not in _vocab_cache:
        if not VOCAB_FILE.exists():
            raise FileNotFoundError(f"committed vocabulary missing: {VOCAB_FILE}")
        C = np.load(VOCAB_FILE)["centroids"].astype(np.float32)
        half_sq = 0.5 * (C * C).sum(axis=1)
        # uploaded without a wait: torch.as_tensor(..., device=) would be a
        # synchronous host-to-device copy
        _vocab_cache[device] = (upload(C, device), upload(half_sq, device))
    return _vocab_cache[device]


def signature_from_descriptors(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, bits) ±1 descriptors + (N,) mask -> (VOCAB_WORDS,) signature: soft
    bag-of-words, Hellinger sqrt, centred and L2-normalised."""
    C, half_sq = _trained_vocabulary(desc.device)
    if C.shape != (VOCAB_WORDS, desc.shape[-1]):
        raise ValueError(f"vocabulary shape {tuple(C.shape)} does not match "
                         f"descriptors of {desc.shape[-1]} bits")
    scores = desc.float() @ C.T - half_sq[None, :]
    p = torch.softmax(TRAINED_BETA * scores, dim=-1)
    w = valid.float()
    hist = torch.sum(p * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)
    sig = torch.sqrt(hist)
    sig = sig - sig.mean()
    n = torch.linalg.norm(sig)
    return sig / torch.clamp(n, min=1e-6)


def score_against_keyframes(sig: torch.Tensor, kf_signatures: torch.Tensor,
                            kf_valid: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of one signature vs all keyframes; -inf where invalid."""
    s = kf_signatures @ sig
    return torch.where(kf_valid, s, float("-inf"))


def centered_cosine_scores(sig: torch.Tensor, kf_signatures: torch.Tensor,
                           kf_valid: torch.Tensor) -> torch.Tensor:
    """Cosine of ``sig`` vs every keyframe signature after both are centred on
    the map's mean signature (the dense-BoW analog of DBoW2's
    inverse-document-frequency weighting; the retrieval score of
    ``loop_closing.detect_loop``). Returns (K,) scores, -inf where invalid."""
    valid_f = kf_valid.to(torch.float32)[:, None]
    mean_sig = (torch.sum(kf_signatures * valid_f, dim=0)
                / torch.clamp(torch.sum(valid_f), min=1.0))
    kf_c = kf_signatures - mean_sig[None, :]
    kf_c = kf_c / torch.clamp(torch.linalg.norm(kf_c, dim=1, keepdim=True), min=1e-6)
    sig_c = sig - mean_sig
    sig_c = sig_c / torch.clamp(torch.linalg.norm(sig_c), min=1e-6)
    return torch.where(kf_valid, kf_c @ sig_c, float("-inf"))
