"""Import-check every examples_torch/*.py script, the port's versions of
examples/: each guards its body under __main__, so an import runs all of
its module-level code (imports, constants) without starting a job; the
set of scripts mirrors examples/, and the README's table names each."""

import glob
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples_torch")
SCRIPTS = sorted(glob.glob(os.path.join(EXAMPLES, "*.py")))


@pytest.mark.parametrize(
    "path", SCRIPTS, ids=[os.path.basename(p) for p in SCRIPTS])
def test_example_imports(path):
    name = "example_torch_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    src = open(path).read()
    assert 'if __name__ == "__main__":' in src
    assert "single_person_pose_estimation_tpu_torch" in src


def test_script_set_mirrors_examples():
    names = {os.path.basename(p) for p in SCRIPTS}
    jax_names = {os.path.basename(p) for p in
                 glob.glob(os.path.join(REPO, "examples", "*.py"))}
    assert names == jax_names and len(names) == 7
    readme = open(os.path.join(EXAMPLES, "README.md")).read()
    assert all(f"`{n}`" in readme for n in names)
