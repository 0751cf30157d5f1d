"""parse_host_ms.dred_dec: host ms a DRED decoding tick spends parsing its
payloads: the host time of the `lpcnet.dred.parse` span (the rows staged,
the one native call that parses every payload, the copy to the card
queued), mean a tick over the traced stretch."""

from benchmark.yardstick.spans import span_means


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.host_ms.get("lpcnet.dred.parse")
