"""The comparison fails its control and the faults a run can have: the
reference a step below the configuration's precision in the program's place,
a farm or scan whose state does not advance, half of the streams left out,
an answer altered where it is produced. Each run is a whole CPU run of the
shrunk cell with the timed path broken underneath."""

import pytest

from perfbench.tests.conftest import CELLS, run_small


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    result = run_small(workload, judge=lambda cell: cell.substitute("truncate_once"))
    assert not result["correct"] and result["checked"]["bad_samples"]["value"] > 0


def _farm_state_unchanged(cell):
    farms = [f for f, _ in cell.farm._groups] if cell.mixed else [cell.farm]
    for farm in farms:
        finish = farm._finish_emit

        def frozen(total, n_out, lanes, farm=farm, finish=finish):
            state = (farm.position_integer, farm.position_fractional)
            out = finish(total, n_out, lanes)
            farm.position_integer, farm.position_fractional = state
            return out

        farm._finish_emit = frozen


def _farm_outputs(cell, change):
    farms = [f for f, _ in cell.farm._groups] if cell.mixed else [cell.farm]
    for farm in farms:
        to_host = farm._to_host

        def changed(lanes, n_out, to_host=to_host):
            out = to_host(lanes, n_out)
            change(out)
            return out

        farm._to_host = changed


def _half_left_out(out):
    out[out.shape[0] // 2 :] = 0


def _one_altered(out):
    out[:, :1] += 1          # each stream's first frame of the call


def _scan_results(cell, change):
    issue = cell.issue

    def changed(k):
        result = issue(k)
        return change(result)

    cell.issue = changed


def _scan_state_unchanged(result):
    outputs, produced, state, over = result
    outputs[1:] = outputs[:1]
    return outputs, produced, state, over


def _scan_half_left_out(result):
    outputs = result[0]
    outputs[:, :, outputs.shape[2] // 2 :] = 0
    return result


def _scan_one_altered(result):
    result[0][0, :1] += 1    # each lane's first frame of the request
    return result


FARM_FAULTS = {"state_unchanged": _farm_state_unchanged,
               "half_left_out": lambda cell: _farm_outputs(cell, _half_left_out),
               "answer_altered": lambda cell: _farm_outputs(cell, _one_altered)}
SCAN_FAULTS = {"state_unchanged": lambda cell: _scan_results(cell, _scan_state_unchanged),
               "half_left_out": lambda cell: _scan_results(cell, _scan_half_left_out),
               "answer_altered": lambda cell: _scan_results(cell, _scan_one_altered)}


@pytest.mark.parametrize("fault", sorted(FARM_FAULTS))
@pytest.mark.parametrize("workload", [c for c in CELLS if not c.endswith(".scan")])
def test_farm_fault_is_not_correct(workload, fault):
    result = run_small(workload, prepare=FARM_FAULTS[fault])
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("fault", sorted(SCAN_FAULTS))
def test_scan_fault_is_not_correct(fault):
    result = run_small("fleet_48k_44k1.scan", prepare=SCAN_FAULTS[fault])
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**32 + 9])
def test_sound_runs_are_correct_on_large_seeds(seed):
    assert run_small("fleet_48k_44k1.stream", seed=seed)["correct"]


def _small_reservoir(monkeypatch):
    """Room for about ten of the shrunk cell's streams of a call."""
    from perfbench.entries import farm

    monkeypatch.setattr(farm, "KEEP_BYTES", 1 << 14)


def test_reservoir_keeps_a_sample_of_the_whole_window(monkeypatch):
    _small_reservoir(monkeypatch)
    cells = []
    result = run_small("fleet_48k_44k1.stream", prepare=cells.append)
    cell = cells[0]
    calls = sorted(slot[0] for slot in cell.slots)
    assert result["correct"] and len(calls) == len(cell.slots) < 16
    assert cell.offered > 4 * len(cell.slots) and calls[-1] >= cell.offered // 4


def test_a_full_reservoir_still_sees_an_altered_answer(monkeypatch):
    _small_reservoir(monkeypatch)
    result = run_small("fleet_48k_44k1.stream", prepare=FARM_FAULTS["answer_altered"])
    assert not result["correct"] and result["failed"] > 0
