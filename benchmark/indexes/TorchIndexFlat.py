"""``faiss_tpu_torch.TorchIndexFlat``: exact k-NN over the stored rows on
one device, with the configuration's ``index.metric`` and
``index.storage``. Its answers are the exact top-k, so it has no
``judge`` of its own: the harness's, over ``reference.py``, judges them."""


def build(config: dict, devices):
    """The empty index on the one device of the cell."""
    import faiss_tpu_torch as ft

    if len(devices) != 1:
        raise SystemExit(f"TorchIndexFlat runs on one device; the cell asks "
                         f"for {len(devices)}")
    ix = config["index"]
    return ft.TorchIndexFlat(config["data"]["d"], metric=ix["metric"],
                             storage=ix["storage"], device=devices[0])


def search_params(sets):
    """One SearchParams a selector set (sorted ids) to admit."""
    import faiss_tpu_torch as ft

    return [ft.SearchParams(sel=ft.IDSelectorBatch(s)) for s in sets]


def fallbacks(index) -> int:
    """Searches so far in which the certificate failed for some query and
    an exact path re-ran it."""
    return index.fused_fallbacks
