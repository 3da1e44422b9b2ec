"""The kernel names chip_smoke.py looks for in a profiler trace exist.

On the card, `chip_smoke.traced_replay` counts the kernels a replayed step
or serving batch runs by substrings of their names (TRACE_NAMES,
ANY_TRACE_NAMES, F16_TRACE, F16B_TRACE, F16B_C5_TRACE, and the
specialised kernels `any_fit_names` says must not run). A name that no
kernel has any more fails only there, deep into the run. Here every
such substring must name at least one `__global__` function of
`nafae_torch/csrc/*.cu`, by the same substring rule."""

import importlib.util
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# __global__ void [__launch_bounds__(...)] name(  (one level of parentheses
# inside the bounds, as in roi_align.cu's)
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                    r"(?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # numpy only at module level
    return mod


CS = _chip_smoke()
KERNELS = sorted({name for src in (ROOT / "nafae_torch" / "csrc").glob("*.cu")
                  for name in GLOBAL.findall(src.read_text())})


def _missing(subs) -> list[str]:
    return sorted(s for s in subs if not any(s in k for k in KERNELS))


def test_kernels_are_found():
    for name in ("ctx_mix_fwd_pairs_any", "ctx_mix_bwd_pairs_any",
                 "ctx_mix_bwd_gather_any", "ctx_mix_bwd_pairs_wide",
                 "ctx_mix_bwd_gather_wide", "cross_mil_any", "nms_kernel",
                 "roi_align_kernel", "diag_scores_any", "diag_sims_any",
                 "diag_bwd_any"):
        assert name in KERNELS, KERNELS


@pytest.mark.parametrize("table", ["TRACE_NAMES", "ANY_TRACE_NAMES",
                                   "F16_TRACE", "F16B_TRACE",
                                   "F16B_C5_TRACE"])
def test_trace_names_exist(table):
    # a tuple names an instantiation: its kernel is its first substring
    subs = {s if isinstance(s, str) else s[0]
            for names in getattr(CS, table).values() for s in names}
    assert not _missing(subs), f"{table}: no kernel named {_missing(subs)}"


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("e", [50, 256, 1024])
def test_fit_names_exist(e, dt):
    for ctx_any in (True, False):
        names, absent = CS.any_fit_names(e, ctx_any, dt)
        subs = {s for v in names.values() for s in v} | set(absent)
        assert not _missing(subs), (e, dt, ctx_any, _missing(subs))
