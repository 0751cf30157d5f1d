"""The plain references the benchmark judges the program's outputs by: one
module per configuration (named in its `configs/*.json` as "reference"),
built on `frozen/`, a frozen copy of the program's plain paths. Nothing
here imports `lpcnet_torch`."""
