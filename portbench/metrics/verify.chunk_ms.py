"""verify.chunk_ms: mean host-clock time of one chunk, from the call of
`verify_many` to its answers on the host, over every chunk of the window
(untraced)."""


def read(rec):
    x = rec["chunk_ms"]
    return sum(x) / len(x) if x else None
