"""Data of the port: tfrecords, the input pipeline, synthetic images and feeding the device."""
