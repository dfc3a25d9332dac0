"""Device-resident MapReduce (the counterpart of the device half of
``hadoop_tpu/mapreduce``): the shuffle and the reduce of records that
already live on the device, over a parallel axis, in
``mapreduce/device_shuffle.py``. The host MapReduce engine is not part
of the port."""
