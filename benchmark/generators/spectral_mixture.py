"""A mixture whose noise has a decaying spectrum, as descriptors compressed
by PCA have: each row and query is a centre drawn at random plus Gaussian
noise whose standard deviation along axis i (1-based) is proportional to
i^(-decay), scaled so that its mean square over the axes is
``noise_scale``², then normalised to unit length where ``data["normalise"]``
says so. Parameters: ``centres``, ``centre_scale``, ``noise_scale``,
``decay``, ``normalise``, ``d``. ``decay`` 0 is ``normalised_mixture``'s
isotropic noise. Rows and queries come from the same mixture."""

import torch


def prepare(data: dict, seed: int, device, g: torch.Generator):
    """(the (centres, d) fp32 centres, the (d,) fp32 noise scale of each
    axis)."""
    d = data["d"]
    cents = data["centre_scale"] * torch.randn(
        (data["centres"], d), generator=g, device=device)
    s = torch.arange(1, d + 1, dtype=torch.float32,
                     device=device) ** (-float(data["decay"]))
    return cents, data["noise_scale"] * s / s.pow(2).mean().sqrt()


def draw(data: dict, state, what: str, n: int,
         g: torch.Generator) -> torch.Tensor:
    """``n`` rows or queries (``what``), (n, d) fp32 on the centres'
    device."""
    cents, scale = state
    idx = torch.randint(0, cents.shape[0], (n,), generator=g,
                        device=cents.device)
    x = cents[idx] + scale * torch.randn((n, data["d"]), generator=g,
                                         device=cents.device)
    if data["normalise"]:
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x.to(torch.float32)
