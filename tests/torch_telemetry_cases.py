"""Shared by the port's telemetry tests (numpy only): two TraceRuns held
event for event."""
import numpy as np

from repro_torch.telemetry import rail


def assert_streams_match(jtr, ttr):
    """Every cell of two TraceRuns event for event: integer fields exact,
    times within rtol 1e-9 (bitwise expected)."""
    assert ttr.coords == jtr.coords
    assert sorted(ttr.cells) == sorted(jtr.cells)
    for key, je in jtr.cells.items():
        te = ttr.cells[key]
        assert sorted(te) == sorted(je)
        for f in rail._FIELDS_I:
            np.testing.assert_array_equal(te[f], je[f], err_msg=(key, f))
            assert te[f].dtype == np.int32
        for f in rail._FIELDS_F:
            np.testing.assert_allclose(te[f], je[f], rtol=1e-9, atol=0,
                                       err_msg=(key, f))
            assert np.array_equal(te[f], je[f]), (key, f, "not bitwise")
