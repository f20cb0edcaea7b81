"""Mean-field dense-CRF refinement in the ConvCRF form.

Port of wild_visual_navigation_tpu/ops/crf.py: pairwise messages truncated
to a window × window neighbourhood (48 offsets at the default 7), each a
shifted comparison of the guide image, Potts compatibility, a fixed
number of mean-field iterations. It serves StegoInterface(run_crf=True),
which is off by default, so it stays plain PyTorch.

Energy: E(x) = Σ_i unary_i(x_i) + Σ_{i, j in window} μ(x_i, x_j)
  · [w_app · exp(−|p_i−p_j|²/2θ_α² − |I_i−I_j|²/2θ_β²) + w_smooth · exp(−|p_i−p_j|²/2θ_γ²)]
with μ = 1[x_i ≠ x_j].
"""

from __future__ import annotations

import torch


def meanfield_crf(logits: torch.Tensor, image: torch.Tensor, iterations: int = 5, window: int = 7,
                  theta_alpha: float = 8.0, theta_beta: float = 0.08, theta_gamma: float = 3.0,
                  w_appearance: float = 3.0, w_smoothness: float = 1.0) -> torch.Tensor:
    """Refine per-pixel class logits (C, H, W) with the guide image (3, H, W)
    in [0, 1]. Returns the refined log-probabilities (C, H, W)."""
    C, H, W = logits.shape
    half = window // 2
    offsets = [(dy, dx) for dy in range(-half, half + 1) for dx in range(-half, half + 1) if (dy, dx) != (0, 0)]
    ys = torch.arange(H, device=logits.device)[:, None]
    xs = torch.arange(W, device=logits.device)[None, :]
    image = image.float()

    weights = []
    for dy, dx in offsets:
        shifted = torch.roll(image, shifts=(-dy, -dx), dims=(1, 2))
        color2 = torch.sum((image - shifted) ** 2, dim=0)
        spatial2 = float(dy * dy + dx * dx)
        w_app = w_appearance * torch.exp(-spatial2 / (2 * theta_alpha**2) - color2 / (2 * theta_beta**2))
        w_smooth = w_smoothness * torch.exp(torch.tensor(-spatial2 / (2 * theta_gamma**2)))
        # neighbours that torch.roll wrapped around the border carry no weight
        valid = (ys + dy >= 0) & (ys + dy < H) & (xs + dx >= 0) & (xs + dx < W)
        weights.append((w_app + w_smooth) * valid)

    q = torch.softmax(logits, dim=0)
    for _ in range(iterations):
        acc = torch.zeros_like(q)
        for w, (dy, dx) in zip(weights, offsets):
            acc = acc + w[None] * torch.roll(q, shifts=(-dy, -dx), dims=(1, 2))
        # Potts: the message of every other label, i.e. the total less one's own
        q = torch.softmax(logits - (acc.sum(0, keepdim=True) - acc), dim=0)
    return torch.log(q.clamp(1e-8, 1.0))


def crf_refine_labels(labels: torch.Tensor, image: torch.Tensor, num_classes: int, confidence: float = 4.0,
                      **kw) -> torch.Tensor:
    """Hard labels (H, W) -> one-hot logits scaled by `confidence` -> CRF ->
    argmax (H, W) int32."""
    onehot = (labels.long()[None] == torch.arange(num_classes, device=labels.device)[:, None, None]).float()
    refined = meanfield_crf((onehot - 0.5) * 2 * confidence, image, **kw)
    return torch.argmax(refined, dim=0).to(torch.int32)
