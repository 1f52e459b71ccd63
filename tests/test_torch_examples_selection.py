"""``examples_torch/sparse_selection.py`` with ``--device cpu`` against
``examples/sparse_selection.py`` (float32): the F1 table of beam search,
OMP and the best l1-path fit at every support size, row for row as both
print it (3 decimals). Apart from tests/test_torch_examples.py because its
20 x 80-sweep l1 path takes most of a minute of eager coordinate steps on
the CPU.
"""
import re

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples import load_example, run_reference  # noqa: E402

ROW = re.compile(r"^\s*(\d+) \| +([\d.]+) \| +([\d.]+) \| +([\d.]+)$", re.M)


def test_sparse_selection_f1_table_equals_the_reference(capsys):
    run_reference("sparse_selection")
    want = ROW.findall(capsys.readouterr().out)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = load_example("examples_torch", "sparse_selection").main(
            ["--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    got = ROW.findall(capsys.readouterr().out)
    assert len(want) == 8 and got == want
    assert [(str(k), f"{b:.3f}", f"{o:.3f}", f"{f:.3f}")
            for k, b, o, f in rows] == want
