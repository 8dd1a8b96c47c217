"""Host utilities of the port (copies of ``arroyo_tpu.utils``)."""
