"""Shares and answers across the two packages, for the mesh tests.

pir_tpu shares of every kind (fast, compat, keyword, multi-party) become
the port's through ``pir_tpu_torch.state``; answers compare as the bytes
of every slot of every result.
"""

from pir_tpu_torch import query as tq
from pir_tpu_torch.dpf import host as thost
from pir_tpu_torch.state import compat_share_from_fields, key_mp_from_fields, share_from_fields


def to_port(shares):
    """pir_tpu shares -> port shares, one PrfKey list per key set (so the
    port sees batch keygen's shared keys as shared, as pir_tpu does)."""
    keysets, out = {}, []
    for s in shares:
        keys = keysets.setdefault(id(s.prf_keys), [thost.PrfKey(k.bytes) for k in s.prf_keys])
        common = dict(prf_keys=keys, share_number=s.share_number, group_size=s.group_size)
        if not s.is_two_party:
            k = s.key_multi_party
            out.append(tq.QueryShare(
                key_two_party=None, key_multi_party=key_mp_from_fields(k.num_parties, k.cw,
                                                                       k.sigma),
                prf_keys=keys, is_keyword_based=s.is_keyword_based, is_two_party=False,
                share_number=s.share_number, group_size=s.group_size))
        elif s.key_fast is not None:
            k = s.key_fast
            out.append(share_from_fields(s_init=k.s_init, t_init=k.t_init, cw=k.cw,
                                         final_cw_block=k.final_cw_block, depth=k.depth,
                                         height=k.height, **common))
        else:
            k = s.key_two_party
            out.append(compat_share_from_fields(s_init=k.s_init, t_init=k.t_init, cw=k.cw,
                                                final_cw=k.final_cw,
                                                is_keyword_based=s.is_keyword_based, **common))
    return out


def answer_bytes(results):
    """Every slot's bytes of every result, for equal-bytes comparisons."""
    return [[bytes(s.data) for s in r.shares] for r in results]


def both(jeng, teng, pairs):
    """Each server's shares of `pairs` through pir_tpu's engine `jeng` and
    the port's `teng`: equal bytes share by share. Returns the port's
    results, one list per server."""
    outs = []
    for k in range(len(pairs[0])):
        shares = [p[k] for p in pairs]
        got = teng.private_secret_shared_query_batch(to_port(shares))
        assert answer_bytes(got) == answer_bytes(jeng.private_secret_shared_query_batch(shares))
        outs.append(got)
    return outs


def recovered(outs, data, rows, group_size=1):
    """True when the servers' results XOR to the data rows `rows`."""
    for i, r in enumerate(rows):
        rec = tq.recover([o[i] for o in outs])
        if [bytes(s.data) for s in rec] != [data[r * group_size + c].tobytes()
                                             for c in range(group_size)]:
            return False
    return True
