"""Paper configurations of the port."""
