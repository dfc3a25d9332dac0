// NativeIO — page-cache discipline for the storage data plane.
//
// Counterpart of the reference's NativeIO layer (ref:
// hadoop-common/src/main/native/src/org/apache/hadoop/io/nativeio/
// NativeIO.c — posix_fadvise + sync_file_range exposed to the
// DataNode so BlockReceiver/BlockSender can drop written/served bytes
// out of the page cache behind the cursor instead of letting dirty
// writeback and cache pollution stall the IO path). Flat C ABI for
// ctypes; no JNI.

#include <fcntl.h>
#include <unistd.h>

extern "C" {

// Advice constants re-exported so the Python side never guesses
// platform values.
int htpu_fadv_sequential() { return POSIX_FADV_SEQUENTIAL; }
int htpu_fadv_dontneed() { return POSIX_FADV_DONTNEED; }
int htpu_fadv_willneed() { return POSIX_FADV_WILLNEED; }

// Returns 0 on success, errno-style positive value on failure.
int htpu_fadvise(int fd, long long offset, long long len, int advice) {
  return posix_fadvise(fd, (off_t)offset, (off_t)len, advice);
}

// Kick writeback for [offset, offset+nbytes) and wait for completion
// when `wait` is nonzero (ref: NativeIO sync_file_range usage under
// dfs.datanode.sync.behind.writes).
int htpu_sync_range(int fd, long long offset, long long nbytes, int wait) {
#ifdef SYNC_FILE_RANGE_WRITE
  unsigned int flags = SYNC_FILE_RANGE_WRITE;
  if (wait) flags |= SYNC_FILE_RANGE_WAIT_AFTER;
  return sync_file_range(fd, (off_t)offset, (off_t)nbytes, flags);
#else
  (void)offset;
  (void)nbytes;
  (void)wait;
  return fdatasync(fd);
#endif
}

}  // extern "C"
