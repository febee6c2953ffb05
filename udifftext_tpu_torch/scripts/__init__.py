"""The port's probes and STR tools, each run as
`python -m udifftext_tpu_torch.scripts.<name>`: the kernel and sizing
probes, the serving front end and benchmark, and the scene-text tools
(`str_train`, `str_tune`, `str_test`, `str_read`, `str_bench`,
`str_abinet_lm_acc`, the LMDB and dataset converters, `preprocess_laion_ocr`)."""
