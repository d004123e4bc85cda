"""The reference against the port at a test's size, the result line, and
faults planted under the timed path that the comparison has to catch."""

import pytest
import torch

from tiny import PAGES, TRAIN, tiny_cell, tiny_cell_object, tiny_run

from portbench import faults, harness, run

KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('name', [PAGES, TRAIN])
@pytest.mark.parametrize('trace', [False, True])
def test_sound_run_is_correct_and_line_has_its_keys(name, trace):
    result, checks = tiny_run(name, trace=trace)
    assert list(result) == KEYS + (['breakdown'] if trace else [])
    assert result['correct'], checks
    assert checks and all(c['value'] <= c['limit'] for c in checks)
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert 'setup_s' in result['metrics'] or trace
    if trace:
        assert {'busy_s', 'window_s'} <= set(result['device'])
        assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}


def test_reference_follows_the_port_closely():
    _, checks = tiny_run(PAGES)
    got = {c['name']: c['value'] for c in checks}
    assert got['logp_gap_p99'] < 1e-4 and got['align_gap_p99'] < 1e-4
    # the search finds no better line than the served one, and the
    # processor writes the page as the reference says
    assert got['search_gap_p99'] < 1e-4 and got['page_lines_wrong'] == 0
    _, checks = tiny_run(TRAIN)
    got = {c['name']: c['value'] for c in checks}
    assert max(got.values()) < 1e-4


def test_window_holds_the_cells_least_units():
    workload, config, traffic, entry = tiny_cell(PAGES)
    result, _ = run.run(workload, config, traffic, entry, 2147483911, 0.0,
                        False, torch.device('cpu'),
                        harness.load_benchmark(), 1)
    assert result['attempted'] >= workload['min_window_units']


def test_a_window_short_of_units_gives_no_result():
    workload, config, traffic, entry = tiny_cell(PAGES)
    # inputs for fewer pages than the cell's tail needs
    workload = dict(workload, pages=workload['min_window_units'])
    with pytest.raises(RuntimeError, match='the window holds'):
        run.run(workload, config, traffic, entry, 2147483911, 0.0, False,
                torch.device('cpu'), harness.load_benchmark(), 1)


@pytest.mark.parametrize('name,fault',
                         [(PAGES, f) for f in faults.PAGES]
                         + [(TRAIN, f) for f in faults.TRAIN])
def test_fault_is_not_correct(monkeypatch, name, fault):
    getattr(faults, fault)(monkeypatch)
    result, checks = tiny_run(name)
    assert not result['correct'], checks


@pytest.mark.cuda
@pytest.mark.parametrize('name', [PAGES, TRAIN])
def test_control_fails_on_the_card(name):
    """The reference in TF32 in the program's place fails a limit (on
    the card: the CPU has no TF32)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: TF32 exists only there')
    cell = tiny_cell_object(name, device='cuda')
    for _ in range(cell.workload['min_window_units']):
        if cell.run_unit(False) is None:
            break
    checks, _ = cell.check()
    limits = {c['name']: c['limit'] for c in checks}
    assert all(c['value'] <= c['limit'] for c in checks), checks
    control = cell.control()
    assert any(control[k] > limits[k] for k in limits if k in control), \
        (control, limits)
