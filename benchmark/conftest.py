"""CPU test sizes of the configurations added after the benchmark's tests.

``benchmark/tests/conftest.py`` cuts each configuration to a CPU run's size
through its table ``TINY`` (departments of one university, support).  A
configuration added since gives its size here; the hook below enters it in
that table when pytest registers the tests' conftest, so every test that
takes its cases from ``BENCHMARK.json`` runs the new cells too.
"""

# lubm100_s100: as lubm10_s100, the same generator at the same support.
TINY = {"lubm100_s100": (2, 20)}


def pytest_plugin_registered(plugin, manager):
    table = getattr(plugin, "TINY", None)
    if isinstance(table, dict) and table is not TINY:
        for config, size in TINY.items():
            table.setdefault(config, size)
