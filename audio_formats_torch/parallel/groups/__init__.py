"""The lockstep groups of ``BatchDecoder``, a module a format family, and
``TABLE``, the one place that decides which group takes a lane.

A lane goes to the first entry whose ``key(decoder)`` is not None, in the
table's order (the JAX package's); the lanes of one key form a group, and
each chunk or shard of it runs ``decode(ctx, decoders, key)``
(``window.GroupContext``), which returns each lane's host PCM or a
``window._PendingGroup``.  A lane no entry keys takes the per-stream
read.  A new lockstep format is a module here and one entry.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import flac, flac_rice, mp3, opus, qoa, vorbis, wav

#: on the two ``af-group`` workers, beside each other
POOL = "pool"
#: after the pooled groups, a shard after another (the JAX package's
#: order for the Opus groups)
AFTER = "after"
#: on a thread of its own beside the others (the mixed Opus group)
THREAD = "thread"


class Entry(NamedTuple):
    #: the group's name (its ``group`` span's format)
    name: str
    #: the stats name of its lanes' format (decoded seconds)
    format: str
    key: Callable
    decode: Callable
    #: POOL, AFTER or THREAD
    schedule: str


def _flac(ctx, decs, nch):
    """FLAC over the wire the batch chose."""
    wire = flac_rice if ctx.flac_wire == "rice" else flac
    return wire.decode(ctx, decs, nch)


TABLE = (
    Entry("mp3", "mp3", mp3.layer3_key, mp3.decode_layer3, POOL),
    Entry("l12", "mp3", mp3.l12_key, mp3.decode_l12, POOL),
    Entry("flac", "flac", flac.group_key, _flac, POOL),
    Entry("qoa", "qoa", qoa.group_key, qoa.decode, POOL),
    Entry("wav", "wav", wav.group_key, wav.decode, POOL),
    Entry("vorbis", "vorbis", vorbis.group_key, vorbis.decode, POOL),
    Entry("opus", "opus", opus.celt_key, opus.decode_celt, AFTER),
    Entry("silk", "opus", opus.silk_key, opus.decode_silk, AFTER),
    Entry("hybrid", "opus", opus.hybrid_key, opus.decode_hybrid, AFTER),
    Entry("opus_mixed", "opus", opus.mixed_key, opus.decode_mixed, THREAD),
)
