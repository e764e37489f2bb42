"""docs/EXAMPLES.md is executable documentation: every worked example in it
runs under doctest (the reference documents each public op with worked
examples that double as test vectors, README.md:35-411 -- this is the same
contract, machine-checked)."""

import doctest
import pathlib

import pint_jax  # noqa: F401  (imported for its side-effect-free surface)

DOCS = pathlib.Path(__file__).resolve().parents[1] / "docs"


def test_examples_md_doctests():
    result = doctest.testfile(
        str(DOCS / "EXAMPLES.md"),
        module_relative=False,
        optionflags=doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS,
    )
    assert result.failed == 0, f"{result.failed} doctest failures"
    # the file must keep covering the full public op surface
    text = (DOCS / "EXAMPLES.md").read_text()
    for op in (
        "add_wrap", "add_unsigned_saturate", "add_signed_saturate",
        "sub_wrap", "sub_unsigned_saturate", "sub_signed_saturate",
        "min_unsigned", "max_unsigned", "min_signed", "max_signed",
        "shift_left", "shift_right_unsigned", "get_signed", "slice_lanes",
        "equal", "not_equal", "pack", "unpack",
    ):
        assert f">>> " in text and op in text, f"no example for {op}"
    assert result.attempted >= 40
