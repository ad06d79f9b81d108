"""Device-trace reduction (utils/profiling.py device_summary) on a small
recorded-format trace."""

import pytest
from jax.profiler import ProfileData

from snesimage.utils.profiling import (
    LIBRARY_GEMM,
    device_summary,
    hlo_kernel_ops,
)

# Two kernels on one stream, one overlapping kernel on a second stream,
# a line that is not a stream (ignored), and a host plane (ignored).
TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #14(Compute)"
    timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000
             stats { metadata_id: 1 str_value: "jit(f)/ssimulacra2/add" } }
    events { metadata_id: 2 offset_ps: 5000000 duration_ps: 1000000 }
  }
  lines {
    id: 2
    name: "Stream #15(Compute)"
    timestamp_ns: 0
    events { metadata_id: 2 offset_ps: 1000000 duration_ps: 2000000 }
  }
  lines {
    id: 3
    name: "XLA Ops"
    timestamp_ns: 0
    events { metadata_id: 3 offset_ps: 0 duration_ps: 2000000 }
    events { metadata_id: 4 offset_ps: 1000000 duration_ps: 5000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_add_fusion" } }
  event_metadata { key: 2 value { id: 2 name: "gemm" } }
  event_metadata { key: 3 value { id: 3 name: "add.1" } }
  event_metadata { key: 4 value { id: 4 name: "dot.2" } }
  stat_metadata { key: 1 value { id: 1 name: "tf_op" } }
}
planes {
  id: 2
  name: "/host:CPU"
  lines {
    id: 1
    name: "python"
    timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 90000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "host_work" } }
}
"""


def test_device_summary_busy_idle_and_scopes():
    summ = device_summary(ProfileData.from_text_proto(TRACE),
                          scopes=("ssimulacra2", "dither_scan"))
    # Kernels cover [0, 3) and [5, 6) us of a 6 us span.
    assert summ["busy_ns"] == pytest.approx(4000.0)
    assert summ["span_ns"] == pytest.approx(6000.0)
    assert summ["idle_share"] == pytest.approx(1 / 3)
    assert summ["scope_ns"] == {"ssimulacra2": pytest.approx(2000.0),
                                "dither_scan": 0.0}
    # gemm: 2 + 1 us in two launches; the fusion: 2 us in one.
    assert [row[:3] for row in summ["top"]] == [
        ("gemm", pytest.approx(3000.0), 2),
        ("loop_add_fusion", pytest.approx(2000.0), 1),
    ]


def test_device_summary_counts_every_stream_line():
    trace = TRACE.replace('name: "XLA Ops"', 'name: "Stream #16(Copy)"')
    summ = device_summary(ProfileData.from_text_proto(trace), top=2)
    # The third stream adds [0, 2) and [1, 6) us: busy is the whole span.
    assert summ["idle_share"] == pytest.approx(0.0)
    assert summ["top"][0][0] == "dot.2"


def test_device_summary_needs_device_events():
    host_only = TRACE[TRACE.index("planes {\n  id: 2"):]
    with pytest.raises(ValueError):
        device_summary(ProfileData.from_text_proto(host_only))


HLO = """
  %input_reduce_fusion.37 = f32[8]{0} fusion(%p), kind=kInput, calls=%fc.1, metadata={op_name="jit(run)/while/body/ssimulacra2/reduce_sum" stack_frame_id=1}
  ROOT %loop-add-fusion.2 = f32[8]{0} fusion(%q), kind=kLoop, calls=%fc.2, metadata={op_name="jit(run)/while/body/add"}
  %custom-call.5 = (f32[8,8]{1,0}, s8[0]{0}) custom-call(%a, %b), custom_call_target="__cublas$gemm", metadata={op_name="jit(run)/ssimulacra2/dot_general"}
"""


def test_hlo_kernel_ops_names_kernels_like_xla():
    ops = hlo_kernel_ops(HLO)
    assert ops["input_reduce_fusion_37"].endswith("ssimulacra2/reduce_sum")
    assert ops["loop_add_fusion_2"] == "jit(run)/while/body/add"
    assert ops[LIBRARY_GEMM] == ("jit(run)/ssimulacra2/dot_general",)


@pytest.mark.parametrize("gemm_scope,want_ns", [("ssimulacra2", 4000.0),
                                                 ("other", 2000.0)])
def test_device_summary_attributes_kernels_through_hlo(gemm_scope, want_ns):
    """Kernels named after HLO fusions take the fusion's op path; library
    GEMMs count for a scope only when every GEMM call lies in it."""
    trace = (
        TRACE.replace('name: "loop_add_fusion"', 'name: "input_reduce_fusion_37"')
        .replace('name: "gemm"', 'name: "sm90_xmma_gemm_f32f32"')
        .replace('str_value: "jit(f)/ssimulacra2/add"', 'str_value: "XlaModule:"')
    )
    hlo = HLO.replace("ssimulacra2/dot_general", f"{gemm_scope}/dot_general")
    summ = device_summary(ProfileData.from_text_proto(trace),
                          scopes=("ssimulacra2",),
                          kernel_ops=hlo_kernel_ops(hlo))
    # The fusion covers [0, 2) us, the GEMMs [1, 3) and [5, 6) us.
    assert summ["scope_ns"]["ssimulacra2"] == pytest.approx(want_ns)
    assert summ["unmapped_ns"] == 0.0
