"""The ctypes declarations of the port's kernel library against the C
entry points in ``ops/csrc/*.cu``, read from the sources: nvcc is not needed,
so a declaration that would pass a pointer as an int, or miss an argument,
fails here rather than on the card."""
import ctypes
import re

import pytest

from tensorkrylov_tpu_torch.ops import _build

_ENTRY = re.compile(r'extern "C" (int64_t|int) (tk_\w+)\(([^)]*)\)', re.S)


def _entry_points():
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in _ENTRY.findall(path.read_text()):
            params = [p.strip() for p in params.split(",") if p.strip()]
            found[name] = (ret, [ctypes.c_void_p if "*" in p else ctypes.c_double if p.startswith("double")
                                 else ctypes.c_int64 for p in params])
    return found


def test_every_declaration_has_an_entry_point_and_back():
    assert set(_entry_points()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_declared_argument_and_return_types(name):
    ret, argtypes = _entry_points()[name]
    assert _build._SIGNATURES[name] == argtypes
    assert (ret == "int64_t") == (name in _build._COUNTS)
