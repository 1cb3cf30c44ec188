"""A clustered mixture, the pattern of ``chip_smoke.ivf_data``: each row
and query is a centre drawn at random plus Gaussian noise, normalised to
unit length where ``data["normalise"]`` says so, as the Deep1B descriptors
are. Parameters: ``centres``, ``centre_scale``, ``noise_scale``,
``normalise``, ``d``. Rows and queries come from the same mixture."""

import torch


def prepare(data: dict, seed: int, device, g: torch.Generator):
    """The (centres, d) fp32 centres."""
    return data["centre_scale"] * torch.randn(
        (data["centres"], data["d"]), generator=g, device=device)


def draw(data: dict, cents: torch.Tensor, what: str, n: int,
         g: torch.Generator) -> torch.Tensor:
    """``n`` rows or queries (``what``), (n, d) fp32 on the centres'
    device."""
    idx = torch.randint(0, cents.shape[0], (n,), generator=g,
                        device=cents.device)
    x = cents[idx] + data["noise_scale"] * torch.randn(
        (n, data["d"]), generator=g, device=cents.device)
    if data["normalise"]:
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x.to(torch.float32)
