"""The TF32 control of a filtered search: reference/exact.py's
SearchControl over a Tf32Store with the rows the filter keeps out at +inf.
Plain PyTorch."""

from __future__ import annotations

from portbench.reference.exact import SearchControl, Tf32Store


class FilteredSearchControl(SearchControl):
    """Exact top-k of the TF32 distances over the rows that pass, returned
    to the host. `excluded` ((N,) bool, True where a row fails the filter)
    is fixed at construction; `search` takes the entry's `id_mask` for the
    program's surface and reads it not at all."""

    def __init__(self, rows, device, excluded):
        self.store = Tf32Store(rows, device, excluded=excluded)

    def search(self, queries, k: int, *, id_mask=None):
        return super().search(queries, k)
