"""The elastic training plane's restore half (the counterpart of
``hadoop_tpu/parallel/elastic/``): ``reshard`` holds the manifest's plan
block and the host-side conversions of ZeRO-1 moments between plan
layouts. The controller, ``ElasticConfig`` and the trainer's
``apply_plan`` are ROADMAP Queue A 6 item 3."""
