"""Packaging: one wheel + console entry point (the reference's shaded-jar
+ bin/ scripts analog — ref: hadoop-client-modules, hadoop-dist,
src/main/bin/hadoop)."""

from setuptools import find_packages, setup

setup(
    name="hadoop-tpu",
    version="0.1.0",
    description=("TPU-native distributed storage, scheduling, and batch "
                 "compute framework"),
    packages=find_packages(include=["hadoop_tpu", "hadoop_tpu.*",
                                   "hadoop_tpu_torch*"]),
    package_data={"hadoop_tpu.native": ["Makefile", "src/*.cc"],
                  "hadoop_tpu_torch.ops": ["csrc/*.cu"]},
    python_requires=">=3.9",
    entry_points={
        "console_scripts": [
            "hadoop-tpu = hadoop_tpu.cli.main:main",
        ],
    },
)
