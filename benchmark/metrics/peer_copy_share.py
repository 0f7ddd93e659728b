"""peer_copy_share (device trace): the device seconds of the traced span's
card-to-card copy records (CUPTI's peer memcpy records, every card's) over
the span's seconds: the share of the span that the expert-parallel exchange
(rows out to the shards, fp32 partials back) keeps a copy engine busy. None
where the span holds no such copy (a one-card run)."""

PEER_COPY = "Memcpy PtoP"


def read(run):
    if run.trace is None:
        return None
    busy = sum(t for n, t in run.trace["by_name"].items() if n.startswith(PEER_COPY))
    return 100.0 * busy / run.trace["window_s"] if busy > 0 else None
