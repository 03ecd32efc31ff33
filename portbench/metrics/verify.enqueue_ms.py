"""verify.enqueue_ms: mean host-clock time from the call of `verify_many`
to its return, before the answers are read back: the host's launch time
of a chunk (near verify.chunk_ms where the launch queue fills)."""


def read(rec):
    x = rec["enqueue_ms"]
    return sum(x) / len(x) if x else None
