"""The harness finds configurations, mixes, metrics and kernel families by
file name: adding a file adds the piece."""

import json
import re

from h100bench import catalog


def test_adding_files_adds_a_cell_a_metric_and_a_pattern(tiny_bench):
    bench = tiny_bench / "bench_h100"
    mix = json.loads((bench / "traffic" / "tiny.json").read_text())
    (bench / "traffic" / "tiny-c1.json").write_text(
        json.dumps(dict(mix, clients=1)))
    (bench / "limits" / "t13-c1.json").write_text("{}")
    (bench / "metrics" / "requests_n.py").write_text(
        "def read(run):\n    return len(run.requests) or None\n")
    (bench / "kernels" / "attention" / "new_kernel.txt").write_text(
        "# a later kernel\nmy_new_attention_kernel\n")
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "t13-c1", "config": "tiny13",
                              "traffic": "tiny-c1", "chips": 1})
    spec["per_layer"].append({"name": "requests_n", "unit": "n",
                              "better": "higher", "source": "host_clock",
                              "layer": "server", "moves": "video_s",
                              "workloads": ["t13-c1"]})
    cell = catalog.Cell(spec, "t13-c1", str(tiny_bench), str(bench))
    assert cell.traffic["clients"] == 1
    assert cell.config["transformer"]["num_layers"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "requests_n"

    class FakeRun:
        requests = [1, 2, 3]

    assert cell.reader(cell.per_layer[-1])(FakeRun()) == 3
    # the metric is listed for its cells only
    other = catalog.Cell(spec, "t13", str(tiny_bench), str(bench))
    assert "requests_n" not in [m["name"] for m in other.per_layer]
    fams = catalog.kernel_families(str(bench))
    assert catalog.family_of("void my_new_attention_kernel<1>()",
                             fams) == "attention"


KERNELS = {
    "void flash_wgmma_kernel<64, 0, false, false, 64>(CUtensorMap)":
        "attention",
    "void flash_int8_wgmma_kernel<128, true, 0, 128>(CUtensorMap)":
        "attention",
    "void quantize_rows_kernel<__nv_bfloat16, 1, 8, 1, true>(RowArgs)":
        "attention",
    "void quantize_rows_kernel<__nv_bfloat16, 0, 8, 1, true>(RowArgs)":
        "linear",
    "void int8_gemm_wgmma_kernel<1>(CUtensorMap, CUtensorMap, int)":
        "linear",
    "void norm_mod_quantize_rows_kernel<__nv_bfloat16, 1, 8, true>()": None,
    "void at::native::vectorized_elementwise_kernel<4, FillFunctor>()":
        None,
}


def test_kernel_names_fall_in_their_families():
    fams = catalog.kernel_families()
    assert set(fams) == {"attention", "linear"}
    for name, family in KERNELS.items():
        assert catalog.family_of(name, fams) == family, name


def test_the_benchmark_file_names_every_piece():
    spec = catalog.load_spec()
    for w in spec["workloads"]:
        cell = catalog.Cell(spec, w["name"])
        assert cell.end_to_end and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", m["name"])
