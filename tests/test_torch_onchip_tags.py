"""A model of the on-chip strip step's exchange (``csrc/lbm_onchip.cuh``,
both on-chip kernels): each halo value one word that carries its step's
tag (step + 1), two slots a direction by step parity, and every edge
cell's thread waiting on its own words, one at a time, until each holds
its step's tag. No fence and no flag: the word is its own signal.

The strips form a ring, as in ``ring_onchip.cu`` (one strip a shard is the
single-device kernel, ``resident_onchip.cu``). Each thread is a coroutine;
every word it stores lands on its own, in a seeded adversarial order, and
a thread reads a word only when the word's tag passes its test. A thread
of a one-row strip updates one column of it and trades both directions; a
two-row strip has a thread a column in each row, the bottom row trading
south and the top row north. Each strip ends a step at a block barrier.
The model holds that every read is the value of the step it is for, in
two buffers (step 0 of a launch sends the loaded strip, each later step's
words are sent from the update of the step before, the last step sends
nothing) and in one (every step sends at its start), over launches whose
tags go on (step_base) and shards whose launches (one card each) start
apart. The flag model beside it (tests/test_torch_resident.py) stays for
the protocol the words replaced.

Three mutants must fail it: one slot in place of two, a >= tag test on
one slot, and a send placed before its thread's own reads."""

import numpy as np
import pytest

# The words an edge cell at column c pulls from a slot: (speed slot q,
# column offset). Row h-1 reads the north slot (speeds 4, 7, 8 at c, c+1,
# c-1), row 0 the south slot (2, 5, 6 at c, c-1, c+1).
_PULLS = {"n": ((0, 0), (1, 1), (2, -1)), "s": ((0, 0), (1, -1), (2, 1))}


class Stuck(AssertionError):
    """No thread can go on and no word is in flight: some read waits for a
    tag that will never come."""


class _Ring:
    """``rows[b]`` (1 or 2) rows of ``nx`` columns in strip b; the strips
    in order around the ring, ``per_card`` of them a card (a shard), each
    card running ``launches`` launches of ``g`` steps, one after the other
    (a card's next launch starts when all of its strips have ended the
    last). ``send``: "update" (two buffers), "start" (one buffer) or
    "early" (the mutant: a thread sends its next step's words before its
    reads); ``slots``: 2, or the mutant 1; ``test``: "==" or the mutant
    ">="."""

    def __init__(self, rows, nx, g, launches=1, per_card=None,
                 send="update", slots=2, test="=="):
        self.rows, self.nx, self.g, self.launches = rows, nx, g, launches
        self.n = len(rows)
        self.per_card = per_card or self.n
        self.send, self.slots, self.test = send, slots, test
        self.words = {}          # (strip, side, slot, q, col) -> (tag, who)
        self.pending = []        # stores in flight: (key, (tag, who))
        self.arrived = {}        # (strip, step) -> threads at its barrier
        self.ended = {}          # (card, launch) -> threads that ended it
        self.wrong = []
        self.reads = 0
        self.threads = []
        for b, h in enumerate(rows):
            for c in range(nx):
                if h == 1:
                    self.threads.append((b, c, ("s", "n")))
                else:
                    self.threads.append((b, c, ("s",)))
                    self.threads.append((b, c, ("n",)))
        self.size = {b: sum(1 for t in self.threads if t[0] == b)
                     for b in range(self.n)}
        card_size = {}
        for b in range(self.n):
            card_size[self._card(b)] = (card_size.get(self._card(b), 0)
                                        + self.size[b])
        self.card_size = card_size

    def _card(self, b):
        return b // self.per_card

    def _store(self, b, sides, step, c):
        """Strip b's words of ``step`` at column c: the bottom row's (side
        "s") into the south neighbour's north slot, the top row's into the
        north neighbour's south slot."""
        for side in sides:
            dst = (b - 1) % self.n if side == "s" else (b + 1) % self.n
            for q in range(3):
                key = (dst, "n" if side == "s" else "s",
                       step % self.slots, q, c)
                self.pending.append((key, (step + 1, (b, step, c))))

    def _passes(self, key, tag):
        have = self.words.get(key, (0, None))[0]
        return have == tag if self.test == "==" else have >= tag

    def _program(self, b, c, sides):
        g, card = self.g, self._card(b)
        for k in range(self.launches):
            if k:
                yield lambda k=k: (self.ended.get((card, k - 1), 0)
                                   == self.card_size[card])
            for s in range(g):
                step = k * g + s
                if self.send == "start" or s == 0:
                    self._store(b, sides, step, c)
                if self.send == "early" and s + 1 < g:
                    self._store(b, sides, step + 1, c)
                yield lambda: True
                for side in sides:
                    src = (b + 1) % self.n if side == "n" else (b - 1) % self.n
                    for q, dc in _PULLS[side]:
                        col = (c + dc) % self.nx
                        key = (b, side, step % self.slots, q, col)
                        yield lambda key=key, t=step + 1: self._passes(key, t)
                        self.reads += 1
                        if self.words[key][1] != (src, step, col):
                            self.wrong.append((b, c, step, key,
                                               self.words[key]))
                if self.send == "update" and s + 1 < g:
                    self._store(b, sides, step + 1, c)
                at = (b, step)
                self.arrived[at] = self.arrived.get(at, 0) + 1
                yield lambda at=at: self.arrived[at] == self.size[b]
            at = (card, k)
            self.ended[at] = self.ended.get(at, 0) + 1

    def run(self, choices):
        """Run to the end, taking the enabled action ``choices`` picks (an
        index modulo their count) at each point: a store landing, or a
        thread whose wait is over going on. Returns the wrong reads;
        raises :class:`Stuck` where nothing can go on before the end."""
        progs = {i: self._program(*t) for i, t in enumerate(self.threads)}
        waits = {i: (lambda: True) for i in progs}
        choices = iter(choices)
        while progs:
            # Stores to one word land in the order they were made (its
            # coherence order); stores to different words in any order.
            first = {}
            for i, (key, _) in enumerate(self.pending):
                first.setdefault(key, i)
            acts = [("land", i) for i in sorted(first.values())]
            acts += [("run", i) for i in progs if waits[i]()]
            if not acts:
                raise Stuck(f"{len(progs)} threads wait, no word in flight")
            kind, x = acts[int(next(choices, 0)) % len(acts)]
            if kind == "land":
                key, word = self.pending.pop(x)
                self.words[key] = word
                continue
            try:
                waits[x] = next(progs[x])
            except StopIteration:
                del progs[x], waits[x]
        return self.wrong


def _runs(n, **kw):
    """Each of ``n`` seeded adversarial runs of a ring built by ``kw``:
    its wrong reads, or "stuck"."""
    rng = np.random.default_rng(sum(map(ord, repr(sorted(kw.items())))))
    for _ in range(n):
        ring = _Ring(**kw)
        try:
            yield ring.run(rng.integers(0, 1 << 30, 20000)), ring
        except Stuck:
            yield "stuck", ring


CASES = {
    # The single-device kernel: one-row strips (128x128 on 132 SMs),
    # two-row strips (256x256), both in one ring, one strip alone.
    "one-row strips": dict(rows=[1, 1, 1], nx=4, g=4),
    "two-row strips": dict(rows=[2, 2, 2], nx=3, g=4),
    "one- and two-row strips": dict(rows=[2, 1, 2, 1], nx=3, g=3),
    "one strip": dict(rows=[1], nx=3, g=4),
    "two strips": dict(rows=[2, 1], nx=3, g=4),
    # The ring: strips of 2 shards on 2 cards, 3 launches each, the tags
    # going on across them, each card's launches apart from the other's.
    "ring across shards and launches": dict(rows=[1, 2, 2, 1], nx=3, g=2,
                                            launches=3, per_card=2),
}


@pytest.mark.parametrize("send", ["update", "start"])
@pytest.mark.parametrize("case", list(CASES))
def test_tagged_words_read_their_own_step(case, send):
    """Two slots, a == test: in two buffers (sends from the update) and in
    one (sends at the step's start) every read is its step's value, and
    every thread reads every word it pulls."""
    kw = CASES[case]
    for wrong, ring in _runs(60, send=send, **kw):
        assert wrong == []
        per_step = sum(3 * len(sides) for _, _, sides in ring.threads)
        assert ring.reads == per_step * kw["g"] * kw.get("launches", 1)


def _fails(n, **kw):
    return any(wrong != [] for wrong, _ in _runs(n, **kw))


@pytest.mark.parametrize("case", ["one-row strips", "two-row strips",
                                  "ring across shards and launches"])
@pytest.mark.parametrize("mutant", [
    dict(slots=1), dict(slots=1, test=">="), dict(send="early")],
    ids=["one slot", "one slot, >= test", "send before the reads"])
def test_mutants_of_the_tagged_words_fail_the_model(case, mutant):
    """One slot a direction (a reader may find its word already refilled
    for the next step: it waits for ever, or with >= takes that value), or
    a send placed before its thread's own reads (the neighbour may then
    refill a slot word a reader of this step has not read yet): some
    seeded order shows it."""
    assert _fails(300, **{**CASES[case], **mutant})
