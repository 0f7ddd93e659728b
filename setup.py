from setuptools import find_packages, setup

setup(
    name="umbrella-tpu",
    version="0.1.0",
    description=("TPU-native speculative-decoding inference engine: AWQ W4A16 "
                 "quantized serving with Sequoia tree speculation on JAX/Pallas"),
    packages=find_packages(include=["umbrella_tpu", "umbrella_tpu.*",
                                    "umbrella_tpu_torch", "umbrella_tpu_torch.*"]),
    package_data={"umbrella_tpu": ["trees/*.json", "data/*.jsonl"],
                  "umbrella_tpu_torch": ["trees/*.json", "data/*.jsonl", "csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.5",
        "numpy",
        "transformers>=4.45",
        "safetensors",
        "optax",
    ],
)
