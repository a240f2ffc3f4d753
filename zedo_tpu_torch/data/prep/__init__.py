"""Raw-download converters of the infant datasets (port of zedo_tpu/data/prep/,
numpy and json only)."""
