from setuptools import find_packages, setup

setup(
    name="cellseg_tpu",
    version="0.1.0",
    description=(
        "TPU-native cell instance segmentation framework "
        "(JAX/XLA/Pallas rebuild of the NeurIPS-CellSeg baseline capabilities)"
    ),
    packages=find_packages(exclude=("tests",)),
    # the PyTorch/CUDA port builds its kernels from these sources
    package_data={"cellseg_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
        "pillow",
        "pandas",
    ],
    entry_points={
        "console_scripts": [
            "pre_process_3class=cellseg_tpu.cli.pre_process_3class:main",
            "model_training_3class=cellseg_tpu.cli.train:main",
            "predict=cellseg_tpu.cli.predict:main",
            "compute_metric=cellseg_tpu.cli.compute_metric:main",
            "cellseg_train_distance=cellseg_tpu.cli.train_distance:main",
            "cellseg_infer_distance=cellseg_tpu.cli.infer_distance:main",
            "cellseg_eval_distance=cellseg_tpu.cli.eval_distance:main",
            "cellseg_time_eval=cellseg_tpu.cli.time_eval:main",
            "cellseg_train_flow=cellseg_tpu.cli.train_flow:main",
            "cellseg_predict_flow=cellseg_tpu.cli.predict_flow:main",
            "cellseg_pre_process_flow=cellseg_tpu.cli.pre_process_flow:main",
            "cellseg_ctc_measure=cellseg_tpu.cli.ctc_measure:main",
        ],
    },
)
