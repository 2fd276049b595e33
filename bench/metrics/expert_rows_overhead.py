"""The expert products' rows run over the rows routed to the experts (1
when the products run on exactly the routed rows, above 1 with padding):
each record's ``rows_computed`` over its ``routed_rows``, summed over the
traced window's records."""


def read(t):
    recs = [r for r in t.records if "rows_computed" in r]
    routed = sum(int(r["routed_rows"]) for r in recs)
    if not routed:
        return None
    return sum(int(r["rows_computed"]) for r in recs) / routed
