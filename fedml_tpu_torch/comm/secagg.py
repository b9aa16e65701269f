"""Dropout-robust secure aggregation in the quantized integer domain
(port of ``fedml_tpu/comm/secagg.py``).

The server learns only the SUM (ROADMAP item 1): every client adds
pairwise cancelling masks to its **fixed-point int64 contribution** —
the exact representation ``PartialAccumulator`` folds — so the pooled
fold over any ``ingest_workers`` count, any arrival order, and any
shard count M cancels the masks EXACTLY (integer adds mod 2^64 are
associative and commutative; cancellation survives the shardplane's
coordinator-side wire merge of per-shard partials unchanged, which is
why this module adds *no* new aggregation path — masked frames ride
``PartialAccumulator.add_fixed`` through the existing pool/shard
plumbing).

Protocol (one epoch = one server incarnation):

1. **Key agreement** — each client draws a DH secret ``sk`` and
   publishes ``pk = g^sk mod p`` (``core/mpc.pk_gen``); the server
   relays the roster of pks. Pair key ``k_ij = key_agreement(sk_i,
   pk_j) = key_agreement(sk_j, pk_i)`` — symmetric, never on the wire.
2. **Share distribution** — each client Shamir-shares its ``sk``
   t-of-n over the fixed worker UNIVERSE (``core/mpc.bgw_encode``,
   evaluation point of worker slot s is s+1) and ships the share for
   peer j encrypted under a one-time pad derived from ``k_ij``. The
   server stores the ciphertext matrix; it cannot decrypt any entry.
3. **Masked upload** — for round r the client quantizes its weighted
   contribution onto the int64 grid (the same
   ``quantize_contribution`` arithmetic the server pool runs), then
   adds ``sign(i, j) * expand(frame_seed(k_ij, epoch, r))`` for every
   roster peer j — the ``randmask`` PRNG-expansion pattern from
   ``comm/codec.py``, widened to full-range uint64 draws. The
   ``frame_seed`` discipline means a cached RESEND of the upload is
   bit-identical and a chaos duplicate is a true duplicate (the
   server's round-dedupe drops it before any fold).
4. **Dropout recovery** — a heartbeat eviction leaves the victim's
   masks orphaned inside the survivors' uploads. The server asks ≥t
   survivors for their (decrypted) shares of the victim's ``sk``,
   reconstructs it (``bgw_decode``), re-derives the victim's pair
   keys from the roster pks, expands the orphaned masks and SUBTRACTS
   them from the merged total; the round then commits over survivors,
   bit-equal to a federation that never had the victim. Reveals are
   epoch-fenced (a share from a previous incarnation is dropped) and
   flight-recorded; a revealed rank is released for the rest of the
   epoch — the server now knows its mask stream, so re-admitting it
   would silently void its privacy.

Threat model (docs/ROBUSTNESS.md "Secure aggregation"): honest-but-
curious server, up to n−t dropouts per round. Everything here is
host-side numpy/python, as in the JAX package — a protocol between trust
domains, not a device kernel. torch has no wrapping ``uint64``
arithmetic, so the masks, the quantized contribution and the fold stay
numpy ``uint64``/``int64`` on the host after the one device→host copy of
an upload; for the same keys, epoch and round every mask, share and
correction is the JAX package's bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from fedml_tpu_torch.comm.codec import frame_seed
from fedml_tpu_torch.core.mpc import (DEFAULT_PRIME, bgw_decode, bgw_encode,
                                      key_agreement, pk_gen)

_M64 = 0xFFFFFFFFFFFFFFFF
#: Domain-separation constants folded into every frame_seed derivation,
#: so the mask stream, the share pads, and the Shamir coefficient rng
#: can never collide even under equal (key, epoch, round) tuples.
_DOM_MASK = 0x5EC0AD
_DOM_PAD = 0x5EC04A
_DOM_SHAMIR = 0x5EC05A


def _gen_sk(p: int = DEFAULT_PRIME) -> int:
    """A DH secret from OS entropy, in [1, p-2]. Tests inject ``sk``
    directly for reproducibility; the bit-equality of the POOLED MEAN
    never depends on the draw (masks cancel exactly for any keys)."""
    return int.from_bytes(os.urandom(8), "big") % (p - 2) + 1


def expand_masks(seed: int, shapes: Sequence[Tuple[int, ...]]
                 ) -> List[np.ndarray]:
    """One pair mask: full-range uint64 leaves expanded from ``seed``
    (Philox bit-stream — stable across numpy versions, same generator
    discipline as the codec's ``randmask`` stage). Both ends — client
    masking and the server's dropout correction — call HERE with the
    same seed and the model's leaf shapes, so the expansion can never
    drift between them."""
    rng = np.random.Generator(np.random.Philox(np.uint64(seed & _M64)))
    total = int(sum(int(np.prod(s, dtype=np.int64)) for s in shapes))
    flat = rng.integers(0, 2 ** 64, size=total, dtype=np.uint64)
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s, dtype=np.int64))
        out.append(flat[off:off + n].reshape(s))
        off += n
    return out


def mask_seed(pair_key: int, epoch: int, round_idx: int) -> int:
    """The per-(pair, epoch, round) mask seed — ``frame_seed`` keyed so
    a resend of the same round's upload regenerates the identical mask
    and every new round gets a fresh stream."""
    return frame_seed(_DOM_MASK, pair_key, epoch, round_idx)


def _share_pad(pair_key: int, epoch: int, owner: int, holder: int,
               p: int) -> int:
    """One-time pad digit in Z_p for the (owner → holder) share cipher,
    derived from the pair key the server never sees."""
    rng = np.random.Generator(np.random.Philox(np.uint64(
        frame_seed(_DOM_PAD, pair_key, epoch, owner, holder) & _M64)))
    return int(rng.integers(0, p))


def resolve_threshold(n: int, requested: int = 0) -> int:
    """The Shamir threshold t for an n-member roster: ``requested`` when
    given, else majority (n//2 + 1). Must satisfy 1 <= t <= n-1 (the
    reveal path reconstructs a DEAD rank's seed from survivors only, so
    t == n could never fire) — except the degenerate n == 1 roster,
    which has no pairs and no shares and takes t = 1."""
    if n <= 1:
        if requested > 1:
            raise ValueError(
                f"secagg_t={requested} impossible for a 1-member roster")
        return 1
    t = int(requested) if requested else n // 2 + 1
    if not 1 <= t <= n - 1:
        raise ValueError(
            f"secagg_t={t} outside [1, {n - 1}] for an {n}-member roster: "
            "the seed-reveal path needs t shares from SURVIVORS of a "
            "1-rank dropout")
    return t


def _as_uint_view(leaves: Iterable[np.ndarray]) -> List[np.ndarray]:
    return [np.ascontiguousarray(l, np.int64).view(np.uint64)
            for l in leaves]


def apply_pair_masks(leaves: List[np.ndarray], rank: int,
                     pair_keys: Dict[int, int], roster: Sequence[int],
                     epoch: int, round_idx: int) -> List[np.ndarray]:
    """Mask a client's int64 contribution IN the integer domain:
    ``u_i = c_i + Σ_j sign(i, j) · m_ij (mod 2^64)`` with ``sign(i, j)
    = +1`` for the lower rank of the pair. Returns int64 leaves (the
    inputs are modified in place through a uint64 bit view — modular,
    warning-free)."""
    views = _as_uint_view(leaves)
    shapes = [v.shape for v in views]
    for j in sorted(roster):
        if j == rank:
            continue
        m = expand_masks(mask_seed(pair_keys[j], epoch, round_idx), shapes)
        for v, mm in zip(views, m):
            if rank < j:
                np.add(v, mm, out=v)
            else:
                np.subtract(v, mm, out=v)
    return [v.view(np.int64) for v in views]


class SecAggClient:
    """One worker's half of the protocol. Created when the client
    adopts an epoch under ``cfg.secagg``; holds the DH secret, the pair
    keys once the roster lands, and the cached encrypted share row (so
    a duplicate ROSTER gets a bit-identical SHARES reply)."""

    def __init__(self, rank: int, epoch: int, *, p: int = DEFAULT_PRIME,
                 sk: Optional[int] = None):
        self.rank = int(rank)
        self.epoch = int(epoch)
        self.p = int(p)
        self.sk = int(sk) if sk is not None else _gen_sk(p)
        self.pk = pk_gen(self.sk, p)
        self.pair_keys: Optional[Dict[int, int]] = None
        self.roster: Optional[Tuple[int, ...]] = None
        self.t: Optional[int] = None
        self._universe: Optional[Tuple[int, ...]] = None
        self._row: Optional[Dict[int, int]] = None

    def build_shares(self, pks: Dict[int, int], t: int,
                     universe: Sequence[int]) -> Dict[int, int]:
        """Handle the server's ROSTER: derive every pair key, Shamir-
        share ``sk`` degree t−1 over the fixed universe, and return the
        encrypted share row ``{holder: cipher}`` for the roster peers.
        Deterministic in (sk, epoch, roster) — the idempotence the
        chaos-duplicate drills rely on."""
        universe = tuple(sorted(int(u) for u in universe))
        roster = tuple(sorted(int(j) for j in pks))
        if self._row is not None and roster == self.roster \
                and universe == self._universe:
            return dict(self._row)
        self.roster, self.t, self._universe = roster, int(t), universe
        self.pair_keys = {
            int(j): key_agreement(self.sk, int(pk), self.p)
            for j, pk in pks.items() if int(j) != self.rank}
        # Shamir coefficients from a stream keyed by the SECRET — secret
        # randomness, deterministic resends.
        rng = np.random.RandomState(
            frame_seed(_DOM_SHAMIR, self.sk, self.epoch) % (2 ** 32))
        shares = bgw_encode(np.asarray([[self.sk]], np.int64),
                            N=len(universe), T=int(t) - 1, p=self.p,
                            rng=rng)
        slot = {r: s for s, r in enumerate(universe)}
        row = {}
        for j in roster:
            if j == self.rank:
                continue
            s_j = int(shares[slot[j], 0, 0])
            pad = _share_pad(self.pair_keys[j], self.epoch, self.rank, j,
                             self.p)
            row[j] = (s_j + pad) % self.p
        self._row = dict(row)
        return row

    def mask(self, leaves: List[np.ndarray], round_idx: int,
             roster: Sequence[int]) -> List[np.ndarray]:
        """Mask this round's int64 contribution over ``roster`` (the
        server-stamped per-round member set — every member of the round
        masks against the same peer set, or nothing cancels)."""
        if self.pair_keys is None:
            raise ValueError(
                f"rank {self.rank}: masking before the roster handshake "
                "completed — the assignment arrived without pair keys")
        missing = [j for j in roster
                   if j != self.rank and j not in self.pair_keys]
        if missing:
            raise ValueError(
                f"rank {self.rank}: round roster names peers {missing} "
                "with no agreed pair key (roster drifted across epochs?)")
        return apply_pair_masks(leaves, self.rank, self.pair_keys,
                                roster, self.epoch, round_idx)

    def reveal_share(self, target: int, cipher: int) -> int:
        """Decrypt this client's stored share of ``target``'s sk for
        the server's dropout-recovery round."""
        if self.pair_keys is None or target not in self.pair_keys:
            raise ValueError(
                f"rank {self.rank}: no pair key for reveal target "
                f"{target}")
        pad = _share_pad(self.pair_keys[target], self.epoch, int(target),
                         self.rank, self.p)
        return (int(cipher) - pad) % self.p


class SecAggServer:
    """The coordinator's half: pk roster + encrypted share matrix +
    per-round rosters + the reveal bookkeeping. Holds NOTHING that lets
    it unmask a live client — pair keys and share plaintexts exist only
    on clients until a reveal round reconstructs a DEAD rank's sk."""

    def __init__(self, universe: Sequence[int], *, t: int = 0,
                 p: int = DEFAULT_PRIME):
        self.universe = tuple(sorted(int(u) for u in universe))
        self.p = int(p)
        self.t_requested = int(t)
        self.t: Optional[int] = None
        self.pks: Dict[int, int] = {}
        self.rows: Dict[int, Dict[int, int]] = {}
        #: The pair-key MESH, frozen the moment every live member's pk is
        #: in: only these ranks ever hold a round slot this epoch. A rank
        #: that missed the handshake window cannot be grafted into a live
        #: mesh (nobody holds a pair key with it) — it is released for
        #: the epoch rather than silently admitted unmasked.
        self.setup_roster: Optional[Tuple[int, ...]] = None
        #: Per-round roster snapshot — stamped into every assignment
        #: (including resends) so a re-admitted client masks against the
        #: same peer set as everyone else in the round.
        self.round_roster: Dict[int, Tuple[int, ...]] = {}
        #: rank → reconstructed sk. Presence means the rank's mask
        #: stream is known to the server: never re-admit it this epoch.
        self.revealed: Dict[int, int] = {}
        self._shares: Dict[int, Dict[int, int]] = {}

    # -- setup ---------------------------------------------------------------
    def add_pk(self, rank: int, pk: int) -> None:
        self.pks.setdefault(int(rank), int(pk))

    def add_row(self, owner: int, row: Dict[int, int]) -> None:
        self.rows.setdefault(int(owner), {int(h): int(c)
                                          for h, c in row.items()})

    def pks_missing(self, members: Iterable[int]) -> List[int]:
        return sorted(m for m in members if m not in self.pks)

    def rows_missing(self, members: Iterable[int]) -> List[int]:
        return sorted(m for m in members if m not in self.rows)

    def setup_complete(self, members: Iterable[int]) -> bool:
        members = list(members)
        return bool(members) and not self.pks_missing(members) \
            and not self.rows_missing(members)

    def roster_payload(self, members: Iterable[int]) -> Dict[str, object]:
        """The ROSTER broadcast body: the member pks, the resolved
        threshold, and the share universe (slot order = Shamir
        evaluation points, fixed for the epoch regardless of churn)."""
        if self.setup_roster is None:
            ranks = sorted(int(m) for m in members)
            missing = self.pks_missing(ranks)
            if missing:
                raise ValueError(
                    f"roster broadcast before pks arrived from {missing}")
            self.t = resolve_threshold(len(ranks), self.t_requested)
            self.setup_roster = tuple(ranks)
        pks = {r: self.pks[r] for r in self.setup_roster}
        return {"pks": pks, "t": int(self.t),
                "universe": list(self.universe)}

    # -- per-round rosters ---------------------------------------------------
    def stamp_roster(self, round_idx: int,
                     members: Iterable[int]) -> Tuple[int, ...]:
        """Snapshot the roster for ``round_idx`` ONCE (first call wins);
        resent assignments re-stamp the stored snapshot."""
        r = int(round_idx)
        if r not in self.round_roster:
            self.round_roster[r] = tuple(sorted(
                m for m in members if self.can_participate(m)))
        return self.round_roster[r]

    def roster_for(self, round_idx: int) -> Tuple[int, ...]:
        return self.round_roster.get(int(round_idx), ())

    def compromised(self, rank: int) -> bool:
        """True once a reveal round for ``rank`` has started or landed —
        from the first SEED_REVEAL ask, the rank's privacy this epoch is
        forfeit, so both states gate re-admission identically."""
        r = int(rank)
        return r in self.revealed or r in self._shares

    def can_participate(self, rank: int) -> bool:
        """A rank may hold a round slot only while it sits in the frozen
        pair-key mesh (``setup_roster``) and its sk is uncompromised —
        after a reveal the server can derive its every future mask (the
        privacy-over-availability rule)."""
        r = int(rank)
        return (self.setup_roster is not None and r in self.setup_roster
                and not self.compromised(r))

    # -- dropout recovery ----------------------------------------------------
    def orphans(self, round_idx: int, arrived: Iterable[int]) -> List[int]:
        """Roster members whose masked upload never folded: their masks
        sit uncancelled in the merged total and need correction."""
        arrived = set(arrived)
        return [d for d in self.roster_for(round_idx) if d not in arrived]

    def unreconstructed(self, round_idx: int,
                        arrived: Iterable[int]) -> List[int]:
        return [d for d in self.orphans(round_idx, arrived)
                if d not in self.revealed]

    def reveal_request(self, target: int, holder: int) -> Optional[int]:
        """The ciphertext of ``holder``'s share of ``target``'s sk (the
        body of a SEED_REVEAL ask), or None when ``target`` never
        shipped a row for that holder."""
        return self.rows.get(int(target), {}).get(int(holder))

    def add_reveal_share(self, target: int, holder: int,
                         share: int) -> bool:
        """Record one survivor's decrypted share; returns True when this
        share newly completes the threshold and reconstructs ``sk``.
        Duplicates (chaos resends) are idempotent by (target, holder)."""
        target, holder = int(target), int(holder)
        if target in self.revealed:
            return False
        got = self._shares.setdefault(target, {})
        got.setdefault(holder, int(share))
        if self.t is None or len(got) < self.t:
            return False
        holders = sorted(got)[:max(self.t, 1)]
        slot = {r: s for s, r in enumerate(self.universe)}
        shares = np.asarray([[[got[h]]] for h in holders], np.int64)
        sk = int(bgw_decode(shares, [slot[h] for h in holders], p=self.p,
                            T=self.t - 1)[0, 0])
        self.revealed[target] = sk
        return True

    def shares_held(self, target: int) -> int:
        return len(self._shares.get(int(target), {}))

    def has_share(self, target: int, holder: int) -> bool:
        return int(holder) in self._shares.get(int(target), {})

    def correction(self, target: int, round_idx: int, epoch: int,
                   peers: Iterable[int],
                   shapes: Sequence[Tuple[int, ...]]) -> List[np.ndarray]:
        """The int64 leaves that cancel ``target``'s orphaned masks out
        of a merged total containing exactly the uploads of ``peers``:
        each arrived peer j folded ``sign(j, target) · m_j,target``, so
        the correction adds ``sign(target, j) · m_j,target``. Pairs
        between two orphans appear in NO folded upload and need no
        correction — hence the sum runs over arrived peers only."""
        sk = self.revealed[int(target)]
        views = [np.zeros(s, np.uint64) for s in shapes]
        for j in sorted(set(int(x) for x in peers)):
            if j == int(target):
                continue
            k = key_agreement(sk, self.pks[j], self.p)
            m = expand_masks(mask_seed(k, epoch, round_idx), shapes)
            for v, mm in zip(views, m):
                if int(target) < j:
                    np.add(v, mm, out=v)
                else:
                    np.subtract(v, mm, out=v)
        return [v.view(np.int64) for v in views]
