"""PyTorch port: the YAML reader and writer (``utils/yaml_subset.py``) that
``Config.load`` and ``Config.save`` use, held against PyYAML's
``safe_load`` / ``safe_dump`` and against the JAX package's ``Config``."""

import datetime
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.utils import yaml_subset
from light_unet_tpu_torch.utils.yaml_subset import YamlSubsetError

REPO = Path(__file__).resolve().parents[1]
SHIPPED = sorted((REPO / "configs").glob("*.yaml"))
SHIPPED_IDS = [p.name for p in SHIPPED]
# the configs both packages read; a SwinUNETR or MedNeXt config is the port's
# alone (the JAX package builds one model)
CONFIGS = [p for p in SHIPPED
           if yaml.safe_load(p.read_text())["model"]["name"] == "Lightweight3DUNet"]
CONFIG_IDS = [p.name for p in CONFIGS]
PORT_ONLY_IDS = [p.name for p in SHIPPED if p not in CONFIGS]


def test_the_three_shipped_configs_are_found():
    """Three configs of the lightweight U-Net, which both packages read, and
    the port's SwinUNETR and MedNeXt configs."""
    assert CONFIG_IDS == ["unet_fl70.yaml", "unet_fl70_pod.yaml", "unet_mixed_fl_dlbcl.yaml"]
    assert PORT_ONLY_IDS == ["mednext_l_k5_roi128.yaml", "swinunetr_fs48_roi96.yaml"]


@pytest.mark.parametrize("path", SHIPPED, ids=SHIPPED_IDS)
def test_shipped_yaml_reads_equal_to_safe_load(path):
    text = path.read_text()
    assert yaml_subset.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=CONFIG_IDS)
def test_config_load_equals_the_jax_config(path):
    assert Config.load(path).to_dict() == JaxConfig.load(path).to_dict()


@pytest.mark.parametrize("path", SHIPPED, ids=SHIPPED_IDS)
def test_save_round_trips_through_safe_load(path, tmp_path):
    cfg = Config.load(path)
    out = tmp_path / "saved.yaml"
    cfg.save(out)
    assert yaml.safe_load(out.read_text()) == cfg.to_dict()
    assert Config.load(out).to_dict() == cfg.to_dict()
    if path in CONFIGS:  # the JAX package reads what the port writes
        assert JaxConfig.load(out).to_dict() == JaxConfig.load(path).to_dict()


@pytest.mark.parametrize("path", CONFIGS, ids=CONFIG_IDS)
def test_safe_dump_of_a_config_reads_back(path):
    data = yaml.safe_load(path.read_text())
    text = yaml.safe_dump(data, default_flow_style=False, sort_keys=True)
    assert yaml_subset.load(text) == data


# YAML 1.1 resolution (PyYAML's implicit resolvers): each plain scalar resolves
# to what ``yaml.safe_load`` gives
TRAPS = ["1.0e-06", "1e-6", "1.0e3", "1.5e+3", "1.0E-06", "yes", "No", "on", "OFF", "y", "n",
         "True", "FALSE", "null", "Null", "~", "", "0x1f", "-0x1F", "017", "08", "0o17", "0b101",
         "1:30", "-1:30", "190:20:30.15", "1_000", "1__0", ".5", "-.5", "1.", "0.", "+12", "-0",
         ".inf", "-.Inf", "+.INF", "2001-12-14", "2001-12-14t21:59:43.10-05:00",
         "2001-12-14 21:59:43.10 Z", "2001-1-1", "0.0.1", "1.2.3", "0", "00", "+", "-x",
         "~/.cache/x", "tcp://localhost:1234", "a b", "<<x", "=x", "-.nan"]


@pytest.mark.parametrize("text", TRAPS)
def test_plain_scalars_resolve_as_safe_load(text):
    src = f"k: {text}\nl: [{text or 'null'}]\n"
    want, got = yaml.safe_load(src), yaml_subset.load(src)
    assert type(got["k"]) is type(want["k"]) and got == want


@pytest.mark.parametrize("text", [".nan", ".NaN", ".NAN"])
def test_nan_resolves_as_safe_load(text):
    got = yaml_subset.load(f"k: {text}\n")["k"]
    assert isinstance(got, float) and math.isnan(got)
    assert math.isnan(yaml.safe_load(f"k: {text}\n")["k"])


DOCS = {
    "nested sequences": "- - 0\n  - 1\n- - 2\n  -\n  - []\n",
    "sequence at its key's indentation": "k:\n- a\n- b: 1\n  c: 2\nz: 1\n",
    "indented sequence with a null entry": "a:\n  - 1\n  -\n  - 3\n",
    "comments everywhere": "# top\na:   # after a key\n  b: 1   # after a value\n\n  # alone\n  c: 'x' # q\n",
    "folded plain": "a: foo\n  bar\n\n  baz # end\nb: 2\n",
    "folded single-quoted": "a: 'it''s\n  long\n\n  text'\n",
    "double-quoted escapes": 'a: "x\\ty\\u00e9\\x41\\\\ \\"q\\""\nb: "line \\\n  joined"\n',
    "flow collections": "a: {x: 1, y: [a, 'b c', null, 1.5]}\nb: []\nc: {}\nd: [ ]\n",
    "quoted and typed keys": "\"a b\": 1\n'c': 2\n1: a\nyes: b\n~: c\n",
    "top-level scalar": "hello\n",
    "top-level sequence": "- 1\n- two\n",
    "empty document": "# nothing\n\n",
    "closed document": "a: 1\n...\n# after\n",
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_documents_of_the_subset_read_as_safe_load(name):
    assert yaml_subset.load(DOCS[name]) == yaml.safe_load(DOCS[name])


UNSUPPORTED = {
    "anchor": ("a: 1\nb: &x 2\n", 2),
    "alias": ("a: 1\nb: *x\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "literal block scalar": ("a: 1\nb: |\n  x\n", 2),
    "folded block scalar": ("a: >\n  x\n", 1),
    "complex key": ("a: 1\n? b\n", 2),
    "directive": ("%YAML 1.1\na: 1\n", 1),
    "document start": ("a: 1\n---\nb: 2\n", 2),
    "a second document": ("a: 1\n...\nb: 2\n", 2),
    "tab indentation": ("a:\n\tb: 1\n", 2),
    "flow over two lines": ("a: 1\nb: [1,\n  2]\n", 2),
    "mapping value in a plain scalar": ("a: 1\nb: c: d\n", 2),
    "bad indentation": ("a: 1\n b: 2\n", 2),
    "unterminated quote": ("a: 1\nb: 'x\n", 2),
    "unknown escape": ('a: 1\nb: "\\q"\n', 2),
    "merge key": ("a: 1\n<<: 2\n", 2),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_syntax_raises_with_its_line(name):
    text, line = UNSUPPORTED[name]
    with pytest.raises(YamlSubsetError) as info:
        yaml_subset.load(text)
    assert info.value.line == line
    assert str(info.value).startswith(f"line {line}: ")


def test_config_load_names_the_line(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("model:\n  groups: 8\n  name: &anchor Lightweight3DUNet\n")
    with pytest.raises(YamlSubsetError, match="line 3: anchors"):
        Config.load(path)


# trees of the subset's types; strings mix YAML indicators, quotes, the
# resolver's traps, non-ASCII text and line breaks
_TEXT = st.text(alphabet=st.sampled_from(
    list("abcXYZ019 _-.:#'\"[]{},&*!|>%@`?~=+/\\\n\t") + ["é", "λ", "€", "😀"]), max_size=12)
_SCALARS = (st.none() | st.booleans() | st.integers(-2**70, 2**70)
            | st.floats(allow_nan=False) | _TEXT | st.sampled_from(TRAPS))
# a key safe_dump writes as a simple key (an empty one, or one with a line
# break, it writes as a complex key: outside the subset)
_KEY_TEXT = _TEXT.filter(lambda s: s and "\n" not in s)
_KEYS = _KEY_TEXT | st.integers(-1000, 1000)
_TREES = st.recursive(
    _SCALARS,
    lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(_KEY_TEXT, inner, max_size=4),
    max_leaves=24)


@settings(max_examples=250, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=st.dictionaries(_KEY_TEXT, _TREES, max_size=5) | _TREES)
def test_hypothesis_trees_written_by_safe_dump_read_back(tree):
    text = yaml.safe_dump(tree, default_flow_style=False, sort_keys=True)
    assert yaml_subset.load(text) == tree


@settings(max_examples=250, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=st.dictionaries(_KEY_TEXT, _TREES, max_size=5) | _TREES)
def test_hypothesis_trees_dumped_read_back_by_both(tree):
    text = yaml_subset.dump(tree)
    assert yaml.safe_load(text) == tree
    assert yaml_subset.load(text) == tree


@settings(max_examples=60, deadline=None)
@given(keys=st.dictionaries(_KEYS, st.integers(), max_size=6))
def test_hypothesis_typed_keys_round_trip(keys):
    if len({type(k) for k in keys}) > 1:  # sort_keys needs one key type
        keys = {str(k): v for k, v in keys.items()}
    text = yaml.safe_dump(keys, default_flow_style=False, sort_keys=True)
    assert yaml_subset.load(text) == keys
    assert yaml.safe_load(yaml_subset.dump(keys)) == keys


def test_dump_writes_safe_dump_style():
    data = {"b": [[0, 1], [0, 2]], "a": {"x": [], "y": {}, "z": 1e-06, "w": "yes"},
            "c": [{"k": 1, "j": [1]}], "d": None, "e": datetime.date(2020, 1, 2).isoformat()}
    assert yaml_subset.dump(data) == yaml.safe_dump(data, default_flow_style=False,
                                                    sort_keys=True)


_NO_PYYAML = """
import sys
sys.modules["yaml"] = None  # an import of yaml fails, as on a host without PyYAML
import json
from pathlib import Path
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch import cli
out = {p.name: Config.load(p).to_dict() for p in sorted(Path("configs").glob("*.yaml"))}
rc = cli.run(["--mode", "split", "--config", "configs/unet_fl70.yaml",
              "--data_root", sys.argv[1], "--splits_dir", sys.argv[2], "--workdir", sys.argv[3]])
assert "yaml" not in [m for m, v in sys.modules.items() if v is not None]
print(json.dumps({"rc": rc, "configs": out}))
"""


def test_configs_load_and_the_cli_splits_without_pyyaml(tmp_path):
    from light_unet_tpu_torch.utils import nifti
    import numpy as np

    raw = tmp_path / "raw"
    (raw / "images").mkdir(parents=True)
    (raw / "labels").mkdir()
    for i in range(1, 8):
        img = np.full((4, 4, 4), float(i), np.float32)
        nifti.save(nifti.Nifti1Image(img, np.eye(4)), raw / f"images/{i:04d}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image((img > 3).astype(np.uint8), np.eye(4)),
                   raw / f"labels/{i:04d}.nii.gz")
    res = subprocess.run([sys.executable, "-c", _NO_PYYAML, str(raw), str(tmp_path / "splits"),
                          str(tmp_path / "work")], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert sorted(got["configs"]) == SHIPPED_IDS
    assert {k: got["configs"][k] for k in CONFIG_IDS} == {
        p.name: JaxConfig.load(p).to_dict() for p in CONFIGS}
    for name in PORT_ONLY_IDS:
        assert got["configs"][name] == Config.load(REPO / "configs" / name).to_dict()
    lists = {s: (tmp_path / f"splits/{s}_list.txt").read_text().split()
             for s in ("train", "val", "test")}
    assert sorted(sum(lists.values(), [])) == [f"{i:04d}" for i in range(1, 8)]
