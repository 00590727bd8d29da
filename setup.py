from setuptools import find_packages, setup

setup(
    name="deep3dmap_tpu",
    version="0.1.0",
    description="TPU-native 3D reconstruction framework (JAX/XLA/Pallas)",
    packages=find_packages(include=["deep3dmap_tpu", "deep3dmap_tpu.*",
                                    "deep3dmap_tpu_torch",
                                    "deep3dmap_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "scipy",
    ],
    include_package_data=True,
    package_data={"deep3dmap_tpu.native": ["csrc/*.cpp"]},
)
