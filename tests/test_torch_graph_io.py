"""The port's graph files (``bfs_tpu_torch.graph.io``) against
``bfs_tpu.graph.io``: Sedgewick and SNAP files that either package writes
are byte-identical and read back to equal ``src``/``dst`` arrays in the
other, with the same errors, and the package exports the readers."""

import numpy as np
import pytest

from bfs_tpu.graph import csr as JC
from bfs_tpu.graph import io as JIO
from bfs_tpu_torch.graph import csr as C
from bfs_tpu_torch.graph import io as IO
from bfs_tpu_torch.graph.generators import rmat_edges


def _pairs(kind: str) -> tuple[int, np.ndarray]:
    if kind == "rmat":
        return 1 << 7, rmat_edges(7, 4, seed=3).astype(np.int32)
    if kind == "multi":  # parallel edges and self-loops
        return 6, np.array([[0, 1], [0, 1], [2, 2], [3, 4], [5, 5], [5, 5], [4, 3]], np.int32)
    return 3, np.zeros((0, 2), np.int32)


def _same(a, b) -> None:
    assert a.num_vertices == b.num_vertices
    np.testing.assert_array_equal(np.asarray(a.src), np.asarray(b.src))
    np.testing.assert_array_equal(np.asarray(a.dst), np.asarray(b.dst))


@pytest.mark.parametrize("kind", ["rmat", "multi", "empty"])
def test_sedgewick_files_cross_read(tmp_path, kind):
    v, pairs = _pairs(kind)
    ours = C.Graph.from_undirected_edges(v, pairs)
    theirs = JC.Graph.from_undirected_edges(v, pairs)
    IO.write_sedgewick(ours, tmp_path / "port.txt")
    JIO.write_sedgewick(theirs, tmp_path / "ref.txt")
    text = (tmp_path / "port.txt").read_text()
    assert text == (tmp_path / "ref.txt").read_text()
    for name in ("port.txt", "ref.txt"):
        _same(IO.read_sedgewick(tmp_path / name), JIO.read_sedgewick(tmp_path / name))
        back = IO.read_sedgewick(tmp_path / name)  # the same edges, in the file's order
        assert sorted(zip(back.src.tolist(), back.dst.tolist())) == sorted(
            zip(ours.src.tolist(), ours.dst.tolist()))
    _same(IO.parse_sedgewick(text, directed=True), JIO.parse_sedgewick(text, directed=True))


def test_write_sedgewick_rejects_an_odd_self_loop():
    g = C.Graph.from_directed_edges(3, np.array([[1, 1], [0, 2], [2, 0]], np.int32))
    with pytest.raises(ValueError, match="self-loop"):
        IO.write_sedgewick(g, "/dev/null")


@pytest.mark.parametrize("kind", ["rmat", "multi"])
@pytest.mark.parametrize("undirected", [True, False])
def test_snap_files_cross_read(tmp_path, kind, undirected):
    v, pairs = _pairs(kind)
    IO.write_snap_edge_list(pairs, tmp_path / "port.txt", name="t", num_vertices=v)
    JIO.write_snap_edge_list(pairs, tmp_path / "ref.txt", name="t", num_vertices=v)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "ref.txt").read_text()
    for name in ("port.txt", "ref.txt"):
        for nv in (None, v + 5):
            got = IO.read_snap_edge_list(tmp_path / name, undirected=undirected, num_vertices=nv)
            want = JIO.read_snap_edge_list(tmp_path / name, undirected=undirected,
                                           num_vertices=nv)
            _same(got, want)
            assert got.num_vertices == max(int(pairs.max()) + 1, nv or 0)


def test_snap_reader_comments_and_errors(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text("% a matrix-market style comment\n# another\n0 3\n3\t1\n\n2 2\n")
    _same(IO.read_snap_edge_list(path), JIO.read_snap_edge_list(path))
    assert IO.read_snap_edge_list(path).num_vertices == 4
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    assert IO.read_snap_edge_list(empty).num_vertices == 0
    bad = tmp_path / "bad.txt"
    bad.write_text("0 1 2\n1 2 3\n")
    for reader in (IO.read_snap_edge_list, JIO.read_snap_edge_list):
        with pytest.raises(ValueError, match="columns"):
            reader(bad)


def test_package_exports_the_readers():
    import bfs_tpu_torch as P

    assert P.parse_sedgewick is IO.parse_sedgewick
    assert P.read_snap_edge_list is IO.read_snap_edge_list
    assert {"parse_sedgewick", "read_snap_edge_list", "read_sedgewick"} <= set(P.__all__)
