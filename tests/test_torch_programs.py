"""The port's four small programs (count-triples, count-distinct-values,
count-conditions, check-hash-collisions) against the JAX package's: the same
standard output, byte for byte, on the same N-Triples, N-Quads and gzip files."""

import gzip

import pytest

from rdfind_tpu.programs import check_hash_collisions as jcheck
from rdfind_tpu.programs import count_conditions as jconds
from rdfind_tpu.programs import count_distinct_values as jdistinct
from rdfind_tpu.programs import count_triples as jcount
from rdfind_tpu_torch.programs import check_hash_collisions as tcheck
from rdfind_tpu_torch.programs import count_conditions as tconds
from rdfind_tpu_torch.programs import count_distinct_values as tdistinct
from rdfind_tpu_torch.programs import count_triples as tcount
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

PROGRAMS = {"count_triples": (jcount, tcount),
            "count_distinct_values": (jdistinct, tdistinct),
            "count_conditions": (jconds, tconds),
            "check_hash_collisions": (jcheck, tcheck)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("progs")
    t = synth.generate_triples(400, seed=3, n_predicates=6, n_entities=50)
    lines = [f'<http://ex/e{s}> <http://ex/p{p}> '
             + (f'"v{o}"' if o % 4 == 0 else f"<http://ex/e{o}>")
             for s, p, o in t]
    nt = "# header\n" + "".join(f"{ln} .\n" for ln in lines[:300])
    (d / "a.nt").write_text(nt)
    with gzip.open(d / "b.nt.gz", "wt") as f:
        f.write("".join(f"{ln} .\n" for ln in lines[300:]))
    (d / "c.nq").write_text("".join(f"{ln} <http://g/{i % 2}> .\n"
                                    for i, ln in enumerate(lines[:150])))
    return {"nt": [str(d / "a.nt"), str(d / "b.nt.gz")],
            "nq": [str(d / "c.nq")]}


@pytest.mark.parametrize("kind", ["nt", "nq"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_output_matches_jax(inputs, capsys, name, kind):
    jmod, tmod = PROGRAMS[name]
    assert jmod.main(inputs[kind]) == 0
    want = capsys.readouterr().out
    assert tmod.main(inputs[kind]) == 0
    assert capsys.readouterr().out == want
    assert want.strip()


@pytest.mark.parametrize("projection", ["s", "po"])
def test_count_conditions_projection_matches_jax(inputs, capsys, projection):
    assert jconds.main(inputs["nt"] + ["--projection", projection]) == 0
    want = capsys.readouterr().out
    assert tconds.main(inputs["nt"] + ["--projection", projection]) == 0
    assert capsys.readouterr().out == want
