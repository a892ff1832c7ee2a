"""A transcode farm's fleet fed chunk by chunk: ``UniformStreamFarm.process``
for a fleet of one ratio, ``MixedStreamFarm.process`` (with the
configuration's ``adjust_stream`` moves at the end of warm-up) for a mixed
one.

The chunks come from a ring of distinct int16 chunks made from the seed at
set-up, on the card by a torch.Generator and copied to host memory (the
farm takes host arrays). Each call's output is dropped before the next
call. The seed picks streams of every call, and a reservoir drawn from the
seed keeps a uniform sample of those streams' frames for the comparison, in
host memory set aside and touched at set-up, so that the window allocates
nothing. Every frame a farm emits is frame n of its stream's whole output,
at the 16.16 phase n * increment (or, after a move, the phase it had then
plus the new increment's steps), so the reference recomputes exactly the
kept frames from the ring.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.references import lanczos16 as ref

# Streams the seed can sample per call: a call k past this count reuses
# call k % SAMPLE_TABLE's draw (and the reservoir's draws wrap alike).
SAMPLE_TABLE = 1 << 17
# Host memory set aside at set-up for the kept frames; a slot holds one
# stream's frames of one call.
KEEP_BYTES = 1 << 27
# Output frames the reference computes in one block.
REFERENCE_BLOCK_FRAMES = 1 << 19


class PhaseGroup:
    """Streams that share one phase: their frame count so far and the
    phase segments [(first frame, its 16.16 phase, reference ratio)]."""

    def __init__(self, members: list, segments: list):
        self.members = members
        self.segments = segments
        self.frames = 0
        self.active = [m for m in members if m is not None]


class FarmCell:
    call_span = "call"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        import clownresampler_tpu_torch as crt

        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.channels = config["channels"]
        groups = config["groups"]
        self.streams = sum(g["streams"] for g in groups)
        model = config["model"]
        self.model = dict(radius=model["radius"], resolution=model["resolution"])
        self.n_in = config["chunk_frames"]
        rng = np.random.default_rng(seed)
        self.sampled = rng.integers(0, self.streams,
                                    size=(SAMPLE_TABLE, traffic["sampled_streams_per_call"]))
        self.draws = rng.random(SAMPLE_TABLE)
        # A call emits about n_in * out / in frames a stream, a few more
        # where the backlog the radius holds back moves (8k -> 48k: 3 more);
        # a slot has room for 64 input frames' worth more, and keeps the
        # first frames of a call that emits still more.
        rates = [g["rates"] for g in groups] + [m["to"][:2] for m in config.get("moves", ())]
        self.slot_frames = max(-(-(self.n_in + 64) * o // i) for i, o in rates)
        slots = max(1, KEEP_BYTES // (4 * self.slot_frames * self.channels))
        self.store = np.ones((slots, self.slot_frames, self.channels), np.int32)
        self.slots: list = [None] * slots   # (call, stream, phase group, first frame, frames)
        self.offered = 0
        self.ring = self._make_ring(seed, traffic["ring"])
        self.mixed = len(groups) > 1 or bool(config.get("moves"))
        specs = []
        self.phase_groups = []
        for g in groups:
            triple = (*g["rates"], g["low_pass"])
            first = len(specs)
            specs += [triple] * g["streams"]
            self.phase_groups.append(PhaseGroup(list(range(first, len(specs))),
                                                [(0, 0, ref.ratio(*triple, **self.model))]))
        self.group_of = np.repeat(np.arange(len(groups)), [g["streams"] for g in groups])
        self.calls = 0
        common = dict(chunk_frames=self.n_in, max_radius=config.get("max_radius"),
                      device=self.device)
        if self.mixed:
            self.farm = crt.MixedStreamFarm(specs, self.channels, **common)
            self.chunks = [list(chunk) for chunk in self.ring]
        else:
            self.farm = crt.UniformStreamFarm(self.streams, self.channels, *specs[0], **common)
            self.chunks = list(self.ring)
        self.records: list = []       # per call: each phase group's frame count

    def _make_ring(self, seed: int, count: int) -> np.ndarray:
        """``count`` distinct (streams, n_in, channels) int16 chunks."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        ring = torch.randint(-32768, 32768, (count, self.streams, self.n_in, self.channels),
                             generator=gen, dtype=torch.int16, device=self.device)
        return ring.cpu().numpy()

    # -- set-up ------------------------------------------------------------
    def instrument(self, spans) -> None:
        """Time the farm's seams: the staging, the launches and the copy
        out (a mixed farm's per group, summed, and its bookkeeping between
        them as the rest of the call)."""
        self.spans = spans
        if not self.mixed:
            spans.wrap(self.farm, "_stage", "stage")
            spans.wrap(self.farm, "_launch", "launch")
            spans.wrap(self.farm, "_to_host", "to_host")
            return
        self.call_span = "grouping"
        spans.wrap(self.farm, "_launch_groups", "launch")
        self._wrapped = set()
        self._wrap_groups()

    def _wrap_groups(self) -> None:
        if not hasattr(self, "_wrapped"):
            return
        for farm, _ in self.farm._groups:
            if id(farm) not in self._wrapped:
                self._wrapped.add(id(farm))
                self.spans.wrap(farm, "_stage_streams", "stage")
                self.spans.wrap(farm, "_finish_emit", "finish", label=None)
                self.spans.wrap(farm, "_to_host", "to_host")

    def warm_up(self) -> None:
        """Calls until every result buffer is pinned and every launch plan
        built; then the configuration's moves, and as many calls again."""
        for _ in range(self.traffic["warmup_calls"]):
            self._account(self.issue(), False, None)
        for move in self.config.get("moves", ()):
            self._move(move["stream"], tuple(move["to"]))
        self._wrap_groups()
        for _ in range(self.traffic["warmup_calls"]):
            self._account(self.issue(), False, None)

    def _move(self, stream: int, triple: tuple) -> None:
        """Re-rate one stream: it leaves its group with the phase it has
        reached, and goes on at the new increment."""
        if not self.farm.adjust_stream(stream, *triple):
            raise RuntimeError(f"adjust_stream refused stream {stream} -> {triple}")
        group = self.phase_groups[self.group_of[stream]]
        group.members = [None if m == stream else m for m in group.members]
        group.active = [m for m in group.members if m is not None]
        n0, t0, old = group.segments[-1]
        here = t0 + (group.frames - n0) * old.increment
        solo = PhaseGroup([stream], group.segments + [
            (group.frames, here, ref.ratio(*triple, **self.model))])
        solo.frames = group.frames
        self.group_of[stream] = len(self.phase_groups)
        self.phase_groups.append(solo)

    # -- the window --------------------------------------------------------
    def issue(self, k=None):
        """One call: the ring's next chunk through the farm."""
        out = self.farm.process(self.chunks[self.calls % len(self.chunks)])
        self.calls += 1
        return out

    def consume(self, k: int, out) -> int:
        return self._account(out, True, k)

    def _account(self, out, keep: bool, window_call) -> int:
        """Advance each phase group's frame count by the call's frames; in
        the window, offer the sampled streams' frames to the reservoir.
        Returns the samples the call completed."""
        counts, samples = [], 0
        for g in self.phase_groups:
            n = len(out[g.active[0]]) if self.mixed else out.shape[1]
            counts.append((g.frames, n))
            g.frames += n
            samples += n * len(g.active) * self.channels
        if keep:
            self.records.append(counts)
            for s in self.sampled[window_call % SAMPLE_TABLE]:
                self._offer(window_call, int(s), out[s], counts[self.group_of[s]][0])
        return samples

    def _offer(self, call: int, stream: int, frames, first: int) -> None:
        """Reservoir sampling: the i-th stream offered takes a slot while
        one is free, then slot j with j drawn uniformly from [0, i] when
        j is a slot, so every offered stream is kept with the same chance."""
        i = self.offered
        self.offered += 1
        j = i if i < len(self.slots) else int(self.draws[i % SAMPLE_TABLE] * (i + 1))
        if j >= len(self.slots):
            return
        n = min(len(frames), self.slot_frames)
        self.store[j, :n] = frames[:n]
        self.slots[j] = (call, stream, self.group_of[stream], first, n)

    def release(self) -> None:
        self.farm = None

    # -- what the readers and the comparison read --------------------------
    def work(self, k: int, taps: bool = True) -> dict:
        """Call k of the window: int16 bytes in, int32 bytes out, and (with
        ``taps``) the live taps x lanes of its frames."""
        tap_lanes, frames_out = 0, 0
        for g, (first, n) in zip(self.phase_groups, self.records[k]):
            lanes = len(g.active) * self.channels
            frames_out += n * lanes
            if taps and n:
                for lo, hi, t0, n0, r in self._pieces(g, first, n):
                    t = t0 + (torch.arange(lo, hi, dtype=torch.int64) - n0) * r.increment
                    tap_lanes += ref.live_taps(t, r) * lanes
        return dict(bytes_in=2 * self.streams * self.n_in * self.channels,
                    bytes_out=4 * frames_out, tap_lanes=tap_lanes, over_link=True)

    @staticmethod
    def _pieces(group: PhaseGroup, first: int, n: int) -> list:
        """Frames [first, first + n) cut at the group's phase segments:
        (lo, hi, phase at segment start, segment's first frame, ratio)."""
        out = []
        bounds = [s[0] for s in group.segments[1:]] + [first + n]
        for (n0, t0, r), end in zip(group.segments, bounds):
            lo, hi = max(first, n0), min(first + n, end)
            if lo < hi:
                out.append((lo, hi, t0, n0, r))
        return out

    def _reference(self, precision: str):
        """The reference of every kept frame, in blocks: yields (pieces,
        (frames, channels) int32 tensor) with pieces (call, stream, first
        frame, end frame, phase at segment start, segment's first frame,
        the kept frames' view)."""
        dev = self.device
        ring = torch.from_numpy(self.ring).to(dev)
        count, streams, n_in, channels = ring.shape
        flat = ring.reshape(-1, channels)
        by_ratio: dict = {}
        for j, slot in enumerate(self.slots):
            if slot is None:
                continue
            call, s, group, first, n = slot
            frames = self.store[j, :n]
            done = 0
            for lo, hi, t0, n0, r in self._pieces(self.phase_groups[group], first,
                                                  frames.shape[0]):
                by_ratio.setdefault(r, []).append(
                    (call, s, lo, hi, t0, n0, frames[done : done + hi - lo]))
                done += hi - lo
        for r, pieces in by_ratio.items():
            for block in _blocks(pieces):
                t = torch.cat([t0 + (torch.arange(lo, hi, dtype=torch.int64) - n0) * r.increment
                               for _, _, lo, hi, t0, n0, _ in block]).to(dev)
                sid = torch.cat([torch.full((hi - lo,), s, dtype=torch.int64)
                                 for _, s, lo, hi, _, _, _ in block]).to(dev)

                def fetch(rows, sid=sid):
                    chunk = torch.div(rows, n_in, rounding_mode="floor") % count
                    idx = (chunk * streams + sid[:, None]) * n_in + rows % n_in
                    x = flat[idx.clamp_min(0)]
                    return torch.where((rows >= 0)[..., None], x, 0)

                yield block, ref.frames(t, r, fetch, precision)

    def substitute(self, precision: str) -> None:
        """The control: the reference at ``precision`` in the place of every
        kept frame the program produced."""
        for block, want in self._reference(precision):
            want, rows = want.cpu().numpy(), 0
            for *_, view in block:
                view[...] = want[rows : rows + view.shape[0]]
                rows += view.shape[0]

    def check(self):
        """Every kept frame against the reference recomputed from the ring:
        [(name, value, limit)] and the number of calls with a wrong frame."""
        bad = worst = checked = 0
        bad_calls = set()
        for block, want in self._reference("exact"):
            got = torch.from_numpy(np.concatenate([f for *_, f in block])).to(want.device)
            diff = (want.to(torch.int64) - got.to(torch.int64)).abs()
            wrong = (diff != 0).any(dim=1).cpu()
            bad += int((diff != 0).sum())
            worst = max(worst, int(diff.max()))
            checked += diff.numel()
            rows = 0
            for call, _, lo, hi, *_ in block:
                if bool(wrong[rows : rows + hi - lo].any()):
                    bad_calls.add(call)
                rows += hi - lo
        unchecked = int(checked == 0)
        return [("bad_samples", bad, 0), ("max_abs_diff", worst, 0),
                ("unchecked", unchecked, 0)], len(bad_calls) + unchecked


def _blocks(pieces: list):
    """The pieces in runs of at most REFERENCE_BLOCK_FRAMES frames."""
    block, frames = [], 0
    for p in pieces:
        block.append(p)
        frames += p[3] - p[2]
        if frames >= REFERENCE_BLOCK_FRAMES:
            yield block
            block, frames = [], 0
    if block:
        yield block


def build(config: dict, traffic: dict, *, seed: int, device: str) -> FarmCell:
    return FarmCell(config, traffic, seed, device)
