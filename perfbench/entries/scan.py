"""Whole files resampled on the card: ``resample_scan_fused`` over a batch
of files already in device memory (``ScanProgram`` on a card), a request
ending when the card has finished it.

The files are made from the seed at set-up, on the device by a
torch.Generator: (chunks, n_in, lanes) int16, one lane a channel of a file.
Every request resamples the same batch from the state (0, 0) into outputs of
its own, which stay on the card. Two requests' outputs are kept for the
comparison (one the seed picks among the first ``kept_window``, and the
last); the reference recomputes the seed's sample of their lanes, every
step, with the step's produced count, the backlog flags and the final
state.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.references import lanczos16 as ref


class ScanCell:
    call_span = "request"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from clownresampler_tpu_torch import fixedpoint as fx
        from clownresampler_tpu_torch.configure import configure
        from clownresampler_tpu_torch.lowlevel import make_device_state
        from clownresampler_tpu_torch.models import KernelModel, table_tensor

        (group,) = config["groups"]
        self.device = torch.device(device)
        self.traffic = traffic
        self.lanes = group["streams"] * config["channels"]
        self.k, self.n_in = traffic["chunks_per_file"], traffic["chunk_frames"]
        rates = (*group["rates"], group["low_pass"])
        model = KernelModel(radius=config["model"]["radius"],
                            resolution=config["model"]["resolution"])
        cfg = configure(*rates, radius=model.radius, resolution=model.resolution)
        inc = fx.calculate_ratio(*group["rates"])
        r = cfg.integer_stretched_kernel_radius
        taps = fx.round_up(2 * r, 8)
        # Room for a step's frames with the first step's radius backlog.
        self.n_out = fx.round_up((((self.n_in + 2 * r) << 16) // inc) + 8, 128)
        self.args = dict(max_taps=taps, n_out=self.n_out, radius=r, increment=inc,
                         table_strided=table_tensor(model.strided_table(cfg.kernel_step_size,
                                                                        taps), self.device))
        self.table = table_tensor(model.table(), self.device)
        self.state = make_device_state(0, 0, cfg, inc, self.device)
        self.ratio = ref.ratio(*rates, radius=model.radius, resolution=model.resolution)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.chunks = torch.randint(-32768, 32768, (self.k, self.n_in, self.lanes),
                                    generator=gen, dtype=torch.int16, device=self.device)
        rng = np.random.default_rng(seed)
        self.pick = int(rng.integers(0, traffic["kept_window"]))
        self.sample_lanes = [np.sort(rng.choice(self.lanes, traffic["sampled_lanes"],
                                                replace=False)) for _ in range(2)]
        self.produced, self.over, self.final = ref.scan_books(self.ratio, self.k, self.n_in,
                                                              self.n_out)
        self.samples = sum(self.produced) * self.lanes
        self.kept: dict = {}
        self.last = None
        self.spans = None
        self.on_card = self.device.type == "cuda"

    def instrument(self, spans) -> None:
        self.spans = spans

    def _request(self):
        from clownresampler_tpu_torch.lowlevel import resample_scan_fused

        if self.spans is not None:
            with self.spans.span("scan_host"):
                result = resample_scan_fused(self.table, self.chunks, self.state, **self.args)
            with self.spans.span("sync"):
                self._sync()
        else:
            result = resample_scan_fused(self.table, self.chunks, self.state, **self.args)
            self._sync()
        return result

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_calls"]):
            self._request()

    def issue(self, k: int):
        return self._request()

    def consume(self, k: int, result) -> int:
        if k == self.pick:
            self.kept[k] = result
        self.last = (k, result)
        return self.samples

    def release(self) -> None:
        """Free what the window made but the two kept requests."""
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1]
        self.last = None

    def work(self, k: int, taps: bool = True) -> dict:
        """A request: its int16 input read once, its produced frames' int32
        outputs written once and their live taps x lanes."""
        tap_lanes = 0
        if taps:
            t = torch.arange(sum(self.produced), dtype=torch.int64) * self.ratio.increment
            tap_lanes = ref.live_taps(t, self.ratio) * self.lanes
        return dict(bytes_in=2 * self.k * self.n_in * self.lanes,
                    bytes_out=4 * sum(self.produced) * self.lanes, tap_lanes=tap_lanes,
                    over_link=False)

    def reference(self, lanes, precision: str = "exact") -> torch.Tensor:
        """The (chunks, n_out, len(lanes)) outputs the scan must give on
        ``lanes``: each step's produced frames, zeros after them."""
        stream = self.chunks.reshape(-1, self.lanes)[:, torch.as_tensor(lanes).to(self.device)]
        total = stream.shape[0]

        def fetch(rows):
            x = stream[rows.clamp(0, total - 1)]
            return torch.where(((rows >= 0) & (rows < total))[..., None], x, 0)

        frames = sum(self.produced)
        t = torch.arange(frames, dtype=torch.int64, device=self.device) * self.ratio.increment
        flat = torch.cat([ref.frames(t[i : i + (1 << 18)], self.ratio, fetch, precision)
                          for i in range(0, frames, 1 << 18)])
        want = torch.zeros((self.k, self.n_out, len(lanes)), dtype=torch.int32,
                           device=self.device)
        done = 0
        for step, n in enumerate(self.produced):
            want[step, :n] = flat[done : done + n]
            done += n
        return want

    def substitute(self, precision: str) -> None:
        """The control: the reference at ``precision`` in the place of the
        kept requests' outputs on their sampled lanes."""
        for (_, result), lanes in zip(sorted(self.kept.items()), self.sample_lanes):
            index = torch.as_tensor(lanes).to(result[0].device)
            result[0][:, :, index] = self.reference(lanes, precision).to(result[0].device)

    def check(self):
        """The kept requests' sampled lanes, produced counts, backlog flags
        and final state against the reference."""
        bad = worst = books = 0
        bad_requests = 0
        for (k, result), lanes in zip(sorted(self.kept.items()), self.sample_lanes):
            outputs, produced, state, over = result
            got = outputs[:, :, torch.as_tensor(lanes).to(outputs.device)]
            diff = (got.to(torch.int64) - self.reference(lanes).to(torch.int64)).abs()
            wrong = int((diff != 0).sum())
            books_wrong = (sum(int(a != b) for a, b in zip(produced.tolist(), self.produced))
                           + int(bool(over) != any(self.over))
                           + int((int(state.position_integer), int(state.position_fractional))
                                 != self.final))
            bad += wrong
            books += books_wrong
            worst = max(worst, int(diff.max()))
            bad_requests += int(wrong > 0 or books_wrong > 0)
        unchecked = int(not self.kept)
        return [("bad_samples", bad, 0), ("max_abs_diff", worst, 0), ("bad_books", books, 0),
                ("unchecked", unchecked, 0)], bad_requests + unchecked


def build(config: dict, traffic: dict, *, seed: int, device: str) -> ScanCell:
    return ScanCell(config, traffic, seed, device)
