"""The port's probes and STR tools, each run as
`python -m udifftext_tpu_torch.scripts.<name>`: the kernel and sizing
probes (`glue_fusion_probe`, `resblock_probe`, `flash_variants`,
`ln_gemm_probe`, `ocr_train_probe`, `sizing_probe`), the stage and floor
probes (`profile_components`, `profile_transformer`, `kv_hoist_probe`,
`step_floor_probe`, `train_probe`, `pipeline_probe`, `perf_probe`,
`test_parity_probe`, `geglu_sweep`), the serving front end and benchmark,
and the scene-text tools (`str_train`, `str_tune`, `str_test`, `str_read`,
`str_bench`, `str_abinet_lm_acc`, the LMDB and dataset converters,
`preprocess_laion_ocr`)."""
