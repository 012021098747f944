"""The port imports neither JAX nor flax nor anything of the JAX package
(`single_person_pose_estimation_tpu` and its submodules): an AST scan of
its sources, of examples_torch/ and of chip_smoke.py, and an import of its
serving, training, data and evaluation modules with all of them blocked.
TensorFlow and Keras (the weight import's) are imported only inside
functions, never when a module of the port is imported."""

import ast
import os
import subprocess
import sys

import single_person_pose_estimation_tpu_torch as port

PORT_DIR = os.path.dirname(os.path.abspath(port.__file__))
REPO = os.path.dirname(PORT_DIR)
BANNED = ("jax", "flax", "jaxlib", "optax", "orbax",
          "single_person_pose_estimation_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    offenders = []
    scanned = 0
    for dirpath, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                scanned += 1
                path = os.path.join(dirpath, f)
                for mod in _imports(path):
                    if mod.split(".")[0] in BANNED:
                        offenders.append(f"{path}: {mod}")
    chip_smoke = os.path.join(REPO, "chip_smoke.py")
    examples = os.path.join(REPO, "examples_torch")
    for path in [chip_smoke] + [os.path.join(examples, f) for f in
                                sorted(os.listdir(examples))
                                if f.endswith(".py")]:
        scanned += 1
        for mod in _imports(path):
            if mod.split(".")[0] in BANNED:
                offenders.append(f"{path}: {mod}")
    assert scanned >= 17 and not offenders, offenders


def _module_level_imports(path):
    """Imports that run when the module is imported: those outside every
    function body (a class body runs at import too)."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                yield node.module
            yield from walk(ast.iter_child_nodes(node))
    yield from walk(ast.parse(open(path).read(), path).body)


def test_tensorflow_is_imported_lazily():
    """No module of the port or of examples_torch/ imports TensorFlow or
    Keras when it is imported; utils/weight_import.py does inside its
    functions."""
    lazy = ("tensorflow", "keras", "tf_keras")
    offenders, inside = [], []
    roots = [PORT_DIR, os.path.join(REPO, "examples_torch")]
    for root in roots:
        for dirpath, _, files in os.walk(root):
            for f in files:
                if not f.endswith(".py"):
                    continue
                path = os.path.join(dirpath, f)
                offenders += [f"{path}: {m}" for m in
                              _module_level_imports(path)
                              if m.split(".")[0] in lazy]
                inside += [m for m in _imports(path)
                           if m.split(".")[0] in lazy]
    assert not offenders, offenders
    assert "tensorflow" in inside


def test_ban_catches_the_jax_package_but_not_the_port():
    banned = lambda mod: mod.split(".")[0] in BANNED
    assert banned("single_person_pose_estimation_tpu.configs.default_config")
    assert banned("single_person_pose_estimation_tpu")
    assert not banned("single_person_pose_estimation_tpu_torch.losses")


def test_new_modules_are_scanned():
    """Every module of the evaluation, mobile, fused-training, entry-point,
    data-parallel, tensor-parallel/spatial and pipeline/dials/weight-import
    slices is among the scanned sources."""
    for rel in ("data/example_codec.py", "data/tfrecord.py",
                "data/images.py", "data/pipeline.py", "data/coco.py",
                "ops/cuda/decode_kernel.py", "evaluation/predict.py",
                "evaluation/oks.py", "evaluation/pck.py",
                "utils/model_utils.py", "ops/cuda/mobile_kernel.py",
                "models/hourglass.py", "models/fused_inference.py",
                "utils/weight_convert.py", "experimental/__init__.py",
                "experimental/bottleneck_grad.py",
                "experimental/fused_train.py",
                "ops/cuda/bottleneck_train_kernel.py",
                "utils/reporting.py", "utils/profiling.py",
                "training/auto_resume.py", "serving_http.py",
                "utils/export.py", "ops/geometry.py", "ops/__init__.py",
                "utils/visualization.py", "demo/__init__.py",
                "demo/demo.py", "demo/webcam.py", "cli.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/distributed.py", "parallel/sharding_rules.py",
                "parallel/spatial.py", "parallel/spatial_model.py",
                "parallel/pipeline.py", "ops/space_to_depth.py",
                "utils/weight_import.py"):
        path = os.path.join(PORT_DIR, rel)
        assert os.path.exists(path), rel
        assert not [m for m in _imports(path) if m.split(".")[0] in BANNED]


def test_serving_and_training_import_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'jaxlib', 'optax', 'orbax',\n"
            "          'single_person_pose_estimation_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import single_person_pose_estimation_tpu_torch.serving as s\n"
            "import single_person_pose_estimation_tpu_torch.utils"
            ".weight_convert\n"
            "import single_person_pose_estimation_tpu_torch.training"
            ".trainer as t\n"
            "from single_person_pose_estimation_tpu_torch.evaluation"
            ".predict import predict_ds\n"
            "from single_person_pose_estimation_tpu_torch.evaluation"
            ".oks import eval_oks\n"
            "from single_person_pose_estimation_tpu_torch.evaluation"
            ".pck import eval_pck\n"
            "from single_person_pose_estimation_tpu_torch.data"
            ".pipeline import DatasetBuilder\n"
            "from single_person_pose_estimation_tpu_torch.data"
            ".coco import generate_records\n"
            "from single_person_pose_estimation_tpu_torch.utils"
            ".model_utils import load_model_from_checkpoint\n"
            "from single_person_pose_estimation_tpu_torch.ops.cuda"
            ".mobile_kernel import fused_uplevel_mobile\n"
            "from single_person_pose_estimation_tpu_torch.experimental"
            ".fused_train import fused_train_apply\n"
            "assert s.PoseServer and t.Trainer and predict_ds\n"
            "assert fused_train_apply\n"
            "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax',\n"
            "               'orbax', 'single_person_pose_estimation_tpu')\n"
            "               and sys.modules[m] for m in sys.modules)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_lazy_public_names_resolve_with_jax_blocked():
    """The JAX package's top-level names: importing the package loads no
    submodule beyond `configs`; each lazy name then resolves, with JAX and
    the JAX package blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'jaxlib', 'optax', 'orbax',\n"
            "          'single_person_pose_estimation_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import single_person_pose_estimation_tpu_torch as p\n"
            "loaded = sorted(m for m in sys.modules\n"
            "                if m.startswith(p.__name__ + '.'))\n"
            "assert all(m.startswith(p.__name__ + '.configs')\n"
            "           for m in loaded), loaded\n"
            "assert p.__all__ == ['Config', 'COCO_INDEX_FLIP_PAIRS',\n"
            "    'COCO_KEYPOINT_LABELS', 'COCO_SKELETON', 'StackedHourglass',\n"
            "    'create_hourglass_model', 'Trainer', 'DatasetBuilder',\n"
            "    'PoseServer'], p.__all__\n"
            "got = {n: getattr(p, n) for n in p.__all__}\n"
            "from single_person_pose_estimation_tpu_torch.models.hourglass"
            " import StackedHourglass, create_hourglass_model\n"
            "assert got['StackedHourglass'] is StackedHourglass\n"
            "assert got['create_hourglass_model'] is create_hourglass_model\n"
            "assert got['Trainer'].get_lattest_weights_model\n"
            "assert got['PoseServer'].__name__ == 'PoseServer'\n"
            "assert got['DatasetBuilder'].__name__ == 'DatasetBuilder'\n"
            "assert len(got['COCO_KEYPOINT_LABELS']) == 17\n"
            "try:\n"
            "    p.NoSuchName\n"
            "except AttributeError:\n"
            "    pass\n"
            "else:\n"
            "    raise AssertionError('unknown name resolved')\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_points_import_with_jax_blocked():
    """The entry-point slice's modules import with JAX, flax, orbax and the
    JAX package blocked, and the CLI's parser builds."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'jaxlib', 'optax', 'orbax',\n"
            "          'single_person_pose_estimation_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from single_person_pose_estimation_tpu_torch import cli\n"
            "from single_person_pose_estimation_tpu_torch.demo import (\n"
            "    demo, webcam)\n"
            "from single_person_pose_estimation_tpu_torch.utils import (\n"
            "    export, profiling, reporting, visualization)\n"
            "from single_person_pose_estimation_tpu_torch.training import (\n"
            "    auto_resume)\n"
            "from single_person_pose_estimation_tpu_torch import (\n"
            "    serving_http)\n"
            "from single_person_pose_estimation_tpu_torch.ops import geometry\n"
            "assert cli.build_parser() and demo.Demo and webcam.run_on_video\n"
            "assert export.export_savedmodel and profiling.trace\n"
            "assert reporting.save_eval_report and visualization.draw_skeleton\n"
            "assert auto_resume.train_with_auto_resume and geometry.crop_and_pad\n"
            "assert serving_http.HttpPoseService\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_parallel_modules_import_with_jax_blocked():
    """The parallel slices' modules, and the workers of their
    multi-process tests, import with JAX, flax and the JAX package
    blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'jaxlib', 'optax', 'orbax',\n"
            "          'single_person_pose_estimation_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.path.insert(0, 'tests')\n"
            "from single_person_pose_estimation_tpu_torch.parallel import (\n"
            "    distributed, mesh, sharding_rules, spatial, spatial_model)\n"
            "import torch_port_dp_worker, torch_port_tp_worker\n"
            "assert sharding_rules.shard_state and spatial.conv_spatial\n"
            "assert spatial_model.spatial_apply and torch_port_tp_worker.main\n"
            "assert mesh.create_mesh and mesh.shard_batch\n"
            "assert distributed.initialize and distributed.aggregate_metrics\n"
            "assert distributed.shard_files_for_process\n"
            "assert torch_port_dp_worker.main\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_pipeline_dials_and_weight_import_import_with_jax_and_tf_blocked():
    """The pipeline, the space-to-depth front, the weight import (its
    TensorFlow is lazy), the GPipe test's worker and every examples_torch/
    script import with JAX, the JAX package and TensorFlow blocked."""
    code = ("import sys, glob, importlib.util\n"
            "for m in ('jax', 'flax', 'jaxlib', 'optax', 'orbax',\n"
            "          'single_person_pose_estimation_tpu', 'tensorflow',\n"
            "          'keras'):\n"
            "    sys.modules[m] = None\n"
            "sys.path.insert(0, 'tests')\n"
            "from single_person_pose_estimation_tpu_torch.parallel import (\n"
            "    pipeline)\n"
            "from single_person_pose_estimation_tpu_torch.ops import (\n"
            "    space_to_depth)\n"
            "from single_person_pose_estimation_tpu_torch.utils import (\n"
            "    weight_import)\n"
            "import torch_port_pp_worker\n"
            "assert pipeline.make_pipeline_train_step and torch_port_pp_worker.main\n"
            "assert space_to_depth.front_conv_s2d and weight_import.validate_import\n"
            "for path in sorted(glob.glob('examples_torch/*.py')):\n"
            "    spec = importlib.util.spec_from_file_location('ex', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
