"""Host-side image and mask processing for serving."""
