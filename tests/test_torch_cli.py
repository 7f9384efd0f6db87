"""The port's CLI against the JAX package's: byte-identical output files for the
same input and flags, and every flag or strategy the port does not run rejected
by name."""

import jax
import pytest

from rdfind_tpu.programs import rdfind as jcli
from rdfind_tpu.utils.synth import write_nt
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.utils import synth


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module: each keeps
    executable memory mappings, and a test process that gathers too many hits
    the kernel's per-process map limit (vm.max_map_count) inside XLA."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def nt_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("nt") / "data.nt"
    write_nt(path, synth.generate_triples(600, seed=4, n_predicates=6,
                                          n_entities=50))
    return str(path)


@pytest.fixture(scope="module")
def small_nt_file(tmp_path_factory):
    """Fewer triples: without --use-fis every capture is kept, and strategies
    2 and 3 then build a sketch for each."""
    path = tmp_path_factory.mktemp("nt") / "small.nt"
    write_nt(path, synth.generate_triples(300, seed=4, n_predicates=6,
                                          n_entities=40))
    return str(path)


@pytest.mark.parametrize("flags", [
    [], ["--use-fis"], ["--use-fis", "--use-ars", "--clean-implied"],
    ["--projection", "po", "--clean-implied"]])
def test_output_file_is_byte_identical(nt_file, tmp_path, flags):
    common = [nt_file, "--support", "3", "--traversal-strategy", "0", *flags]
    out_j, out_t = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jcli.main(common + ["--output", str(out_j)]) == 0
    assert tcli.main(common + ["--output", str(out_t), "--device", "cpu"]) == 0
    want = out_j.read_bytes()
    assert want.count(b"\n") > 0
    assert out_t.read_bytes() == want


@pytest.mark.parametrize("flags", [[], ["--use-fis", "--clean-implied"]])
@pytest.mark.parametrize("strategy", ["2", "3"])
def test_approximate_strategies_write_the_jax_file(small_nt_file, tmp_path,
                                                   strategy, flags):
    common = [small_nt_file, "--support", "3", "--traversal-strategy", strategy,
              *flags]
    out_j, out_t = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jcli.main(common + ["--output", str(out_j)]) == 0
    assert tcli.main(common + ["--output", str(out_t), "--device", "cpu"]) == 0
    want = out_j.read_bytes()
    assert want.count(b"\n") > 0
    assert out_t.read_bytes() == want


def test_count_line_and_collect_result(nt_file, capsys):
    args = [nt_file, "--support", "3", "--traversal-strategy", "0"]
    assert jcli.main(args) == 0
    want = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert tcli.main(args + ["--device", "cpu", "--collect-result"]) == 0
    assert capsys.readouterr().out.count(" < ") > 0


@pytest.mark.parametrize("flags", [
    [], ["--use-fis", "--clean-implied"], ["--balanced-overlap-candidates"],
    ["--traversal-strategy", "1", "--projection", "so"]])
def test_default_strategy_writes_the_jax_file(small_nt_file, tmp_path, flags):
    """No strategy flag: small-to-large, as in the JAX package's CLI."""
    common = [small_nt_file, "--support", "3", *flags]
    out_j, out_t = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jcli.main(common + ["--output", str(out_j)]) == 0
    assert tcli.main(common + ["--output", str(out_t), "--device", "cpu"]) == 0
    want = out_j.read_bytes()
    assert want.count(b"\n") > 0
    assert out_t.read_bytes() == want


@pytest.mark.parametrize("argv,needle", [
    (["--explicit-threshold", "5"], "ROADMAP.md, queue 1"),
    (["--sbf-bytes=3"], "--sbf-bytes"),
    (["--traversal-strategy", "0", "--dop", "2"], "--dop"),
    (["--traversal-strategy", "0", "--prefixes", "p.txt"], "--prefixes"),
    (["--traversal-strategy", "0", "--projection", "x"], "--projection"),
])
def test_unported_flags_are_rejected_by_name(nt_file, capsys, argv, needle):
    with pytest.raises(SystemExit) as exc:
        tcli.main([nt_file, *argv, "--device", "cpu"])
    assert exc.value.code == 2
    assert needle in capsys.readouterr().err
