"""The port's input path against the reference, on files the tests write.

- ``tpu_als_torch.io.fastcsv`` (the port's copy of the native reader,
  built with g++ into ``tpu_als_torch/_build/``) against its Python twin
  ``tpu_als_torch.io.ratings_csv`` and the reference's loaders: equal
  columns and dtypes, and the same ``ValueError`` on a malformed line;
- the MovieLens loaders (``u.data``, ``ratings.dat``, ``ratings.csv``
  and the three title tables) against the reference's, equal;
- ``python -m tpu_als_torch.cli train --data ml-100k:|dat:|csv:`` and
  ``recommend --titles`` on the CPU;
- on a host without ``g++`` the loaders and ``train --data csv:`` read
  through the Python twin, chosen before reading.

Every comparison is exact: both sides parse the same text into the same
dtypes.
"""

import json
import mmap
import os

import numpy as np
import pytest

from tpu_als.io import movielens as jml
from tpu_als_torch import cli
from tpu_als_torch.core import ratings as tr
from tpu_als_torch.io import _native_build, fastbucket, fastcsv
from tpu_als_torch.io import ratings_csv
from tpu_als_torch.io import movielens as tml
from tpu_als_torch.io.ratings_csv import load_ratings_csv as twin

COLS = ("user", "item", "rating", "timestamp")
HEADER = "userId,movieId,rating,timestamp\n"


def _ratings(seed=0, n=400, nu=30, ni=20):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, nu + 1, n), rng.integers(1, ni + 1, n),
            rng.integers(1, 11, n) * 0.5,
            rng.integers(800_000_000, 1_600_000_000, n))


def _assert_frames_equal(a, b, cols=COLS):
    for c in cols:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)
        assert np.asarray(a[c]).dtype == np.asarray(b[c]).dtype, c


def _write_csv(path, rows, final_newline=True, crlf=()):
    lines = [HEADER.rstrip("\n")]
    for k, (u, i, r, t) in enumerate(zip(*rows)):
        lines.append(f"{u},{i},{r:g},{t}" + ("\r" if k in crlf else ""))
        if k == 5:
            lines.append("")  # an empty line is allowed
    text = "\n".join(lines) + ("\n" if final_newline else "")
    path.write_text(text)


@pytest.mark.parametrize("final_newline", [True, False])
def test_csv_native_twin_and_reference_equal(tmp_path, final_newline):
    p = tmp_path / "ratings.csv"
    _write_csv(p, _ratings(), final_newline, crlf=(3, 7))
    got = tml.load_movielens_csv(str(p))
    _assert_frames_equal(got, twin(str(p)))
    _assert_frames_equal(got, jml.load_movielens_csv(str(p)))
    _assert_frames_equal(tml.load_movielens_csv(str(tmp_path)), got)
    u, i, r, t = fastcsv.load_ratings_csv(str(p), n_threads=1)
    np.testing.assert_array_equal(r, got["rating"])
    assert len(u) == 400


def test_csv_edge_spellings_equal(tmp_path):
    p = tmp_path / "ratings.csv"
    p.write_text(HEADER + "1,2,3.5,100\r\n\n-7,9223372036854775807,5e-1,0  "
                 "\n40,50,1,7\n3,4,1e-50,9")
    _assert_frames_equal(tml.load_movielens_csv(str(p)), twin(str(p)))
    _assert_frames_equal(tml.load_movielens_csv(str(p)),
                         jml.load_movielens_csv(str(p)))


def test_csv_empty_file_and_page_multiple(tmp_path):
    p = tmp_path / "empty.csv"
    p.write_text("")
    for frame in (tml.load_movielens_csv(str(p)), twin(str(p))):
        assert all(len(frame[c]) == 0 for c in COLS)
    # exactly a page of bytes with no final newline: the heap copy path
    line = "1,2,3.5,100\n"
    body = HEADER + line * ((mmap.PAGESIZE - len(HEADER)) // len(line) - 1)
    body += "9,8,2.0," + "7" * (mmap.PAGESIZE - len(body) - 8)
    p = tmp_path / "page.csv"
    p.write_text(body)
    assert os.path.getsize(p) % mmap.PAGESIZE == 0
    _assert_frames_equal(tml.load_movielens_csv(str(p)), twin(str(p)))


@pytest.mark.parametrize("bad", ['1,2,"3.0",4', "1,2,3", "1,2,nan,4",
                                 "1,2,inf,4", "1,2,1e40,4", "1,2,3,4,5",
                                 "1,2,3.0x,4", "1;2;3;4", "1,ten,3,4",
                                 "1,9223372036854775808,3,4"])
def test_csv_malformed_lines_raise(tmp_path, bad):
    p = tmp_path / "bad.csv"
    p.write_text(f"{HEADER}1,2,3,4\n{bad}\n5,6,1.5,7\n")
    for load in (tml.load_movielens_csv, twin, jml.load_movielens_csv):
        with pytest.raises(ValueError, match="malformed ratings line"):
            load(str(p))


def test_u_data_equal(tmp_path):
    u, i, r, t = _ratings(1)
    r = np.ceil(r).astype(np.int64)  # ml-100k's ratings are whole stars
    d = tmp_path / "ml-100k"
    d.mkdir()
    (d / "u.data").write_text("".join(
        f"{a}\t{b}\t{c}\t{e}\n" for a, b, c, e in zip(u, i, r, t)))
    got = tml.load_movielens_100k(str(d))
    _assert_frames_equal(got, jml.load_movielens_100k(str(d / "u.data")))
    assert len(got["user"]) == 400
    (d / "u.data").write_text("1\t2\t3\t4\n1\t2\n")
    with pytest.raises(ValueError, match="malformed ratings line"):
        tml.load_movielens_100k(str(d))


@pytest.mark.parametrize("bad", ["1\t2\t3", "1\t2\t3\t4\t5", "1\t2\tnan\t4",
                                 "1,2,3,4", "1\t2\t3.0x\t4", '1\t"2"\t3\t4'])
def test_u_data_twin_raises_as_native(tmp_path, bad):
    p = tmp_path / "u.data"
    p.write_text(f"1\t2\t3\t4\n{bad}\n5\t6\t1\t7\n")
    for load in (fastcsv.load_u_data, ratings_csv.load_u_data):
        with pytest.raises(ValueError, match="malformed ratings line"):
            load(str(p))
    p.write_text("1\t2\t3\t4\r\n\n 5\t6\t1.5\t7  \n8\t9\t2\t10")
    _assert_frames_equal(ratings_csv.load_u_data(str(p)),
                         tml._frame(*fastcsv.load_u_data(str(p))))


def test_dat_half_stars_equal(tmp_path):
    u, i, r, t = _ratings(2)
    p = tmp_path / "ratings.dat"
    p.write_text("".join(f"{a}::{b}::{c:g}::{e}\n"
                         for a, b, c, e in zip(u, i, r, t)))
    got = tml.load_movielens_dat(str(tmp_path))
    _assert_frames_equal(got, jml.load_movielens_dat(str(p)))
    assert set(np.unique(got["rating"] * 2) % 2) == {0.0, 1.0}
    p.write_text("1::2::3.5::4\n1::2\n")
    for load in (tml.load_movielens_dat, jml.load_movielens_dat):
        with pytest.raises(ValueError, match="malformed ratings line"):
            load(str(p))


def _title_files(tmp_path):
    titles = {1: "Toy Story (1995)", 2: "Amélie (2001)",
              3: "Heat, Part 1 (1995)"}
    out = {}
    d = tmp_path / "csv"
    d.mkdir()
    (d / "movies.csv").write_text(
        "movieId,title,genres\n" + "".join(
            f'{k},"{v}",Drama\n' for k, v in titles.items()),
        encoding="utf-8")
    out["movies.csv"] = d
    for enc in ("utf-8", "latin-1"):
        d = tmp_path / f"dat-{enc}"
        d.mkdir()
        (d / "movies.dat").write_bytes("".join(
            f"{k}::{v}::Drama\n" for k, v in titles.items()).encode(enc))
        out[f"movies.dat {enc}"] = d
    d = tmp_path / "item"
    d.mkdir()
    (d / "u.item").write_bytes("".join(
        f"{k}|{v}|01-Jan-1995||http://x|0|1\n"
        for k, v in titles.items()).encode("latin-1"))
    out["u.item"] = d
    return titles, out


def test_movie_titles_equal_in_all_three_formats(tmp_path):
    titles, dirs = _title_files(tmp_path)
    for name, d in dirs.items():
        got = tml.load_movielens_movies(str(d))
        _assert_frames_equal(got, jml.load_movielens_movies(str(d)),
                             ("item", "title"))
        assert dict(zip(got["item"].tolist(), got["title"].tolist())) \
            == titles, name
    with pytest.raises(FileNotFoundError):
        tml.load_movielens_movies(str(tmp_path))


def _fit_args(spec, out):
    return ["train", "--data", spec, "--rank", "3", "--max-iter", "2",
            "--holdout", "0.1", "--device", "cpu", "--output", str(out)]


def test_cli_train_on_every_file_spec_and_recommend_titles(tmp_path,
                                                           capsys):
    u, i, r, t = _ratings(3, n=600)
    files = {}
    (tmp_path / "u.data").write_text("".join(
        f"{a}\t{b}\t{int(np.ceil(c))}\t{e}\n" for a, b, c, e in
        zip(u, i, r, t)))
    files["ml-100k"] = tmp_path / "u.data"
    (tmp_path / "ratings.dat").write_text("".join(
        f"{a}::{b}::{c:g}::{e}\n" for a, b, c, e in zip(u, i, r, t)))
    files["dat"] = tmp_path / "ratings.dat"
    _write_csv(tmp_path / "ratings.csv", (u, i, r, t))
    files["csv"] = tmp_path / "ratings.csv"
    for kind, path in files.items():
        out = tmp_path / f"model-{kind}"
        cli.main(_fit_args(f"{kind}:{path}", out))
        rmse = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(rmse["holdout_rmse"]), kind
        assert os.path.exists(out / "manifest.json")
        assert os.path.exists(out / "obs" / "events.jsonl")
    titles, dirs = _title_files(tmp_path)
    cli.main(["recommend", "--model", str(tmp_path / "model-csv"), "--k",
              "4", "--users", "1,2", "--titles", str(dirs["movies.csv"]),
              "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["user"] for x in lines] == [1, 2]
    for x in lines:
        assert len(x["titles"]) == len(x["items"]) == 4
        assert x["titles"] == [titles.get(item) for item, _ in x["items"]]
    with pytest.raises(SystemExit, match="unknown data spec"):
        cli.main(_fit_args("parquet:x", tmp_path / "nope"))


def test_without_gxx_the_loaders_and_cli_read_through_the_twin(
        tmp_path, monkeypatch, capsys):
    """No ``g++`` on the PATH: ``csv:`` and ``ml-100k:`` read with the
    Python twin and the blocking runs in numpy, both chosen up front (the
    native libraries are never asked for), with the reference's output."""
    u, i, r, t = _ratings(4, n=500)
    _write_csv(tmp_path / "ratings.csv", (u, i, r, t))
    (tmp_path / "u.data").write_text("".join(
        f"{a}\t{b}\t{int(np.ceil(c))}\t{e}\n" for a, b, c, e in
        zip(u, i, r, t)))
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    assert not _native_build.have_compiler()

    def no_native():
        raise AssertionError("a native library was asked for")

    monkeypatch.setattr(fastcsv, "load", no_native)
    monkeypatch.setattr(fastbucket, "load", no_native)
    _assert_frames_equal(tml.load_movielens_csv(str(tmp_path)),
                         jml.load_movielens_csv(str(tmp_path / "ratings.csv")))
    _assert_frames_equal(tml.load_movielens_100k(str(tmp_path)),
                         jml.load_movielens_100k(str(tmp_path / "u.data")))
    for kind, name in (("csv", "ratings.csv"), ("ml-100k", "u.data")):
        cli.main(_fit_args(f"{kind}:{tmp_path / name}",
                           tmp_path / f"model-{kind}"))
        rmse = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(rmse["holdout_rmse"]), kind
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tr.build_csr_buckets(u - 1, i - 1, r.astype(np.float32), 30,
                             native=True)
