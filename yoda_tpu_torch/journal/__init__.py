"""Durable claim journal: the commit point behind an interface.

Two implementations of :class:`CommitLog`: the in-memory accountant's
default (``NullCommitLog`` — journal off, zero durability, today's
behavior) and :class:`FileJournal` — an append-only, CRC-checksummed,
segment-rotated on-disk log of every claim mutation, replayed on standby
promotion to warm-start the accountant before the first queue pop.

Counterpart of ``yoda_tpu/journal/__init__.py``. ``yoda_tpu_torch.journal.tail``
(imported directly, not re-exported here — it pulls in the commit
transport) holds :class:`~yoda_tpu_torch.journal.tail.JournalTailer`, the
journal-shipping hot standby that streams committed frames from the live
parent so promotion is a warm handover instead of a cold replay.
"""

from yoda_tpu_torch.journal.journal import (
    CLAIM_CHIPS,
    CLAIM_GANG,
    CLAIM_NODE,
    CLAIM_SEQ,
    CLAIM_SHARD,
    CommitLog,
    FileJournal,
    JournalFault,
    NullCommitLog,
    RealJournalIO,
    ReplayedState,
    claim,
)

__all__ = [
    "CLAIM_CHIPS",
    "CLAIM_GANG",
    "CLAIM_NODE",
    "CLAIM_SEQ",
    "CLAIM_SHARD",
    "CommitLog",
    "FileJournal",
    "JournalFault",
    "NullCommitLog",
    "RealJournalIO",
    "ReplayedState",
    "claim",
]
